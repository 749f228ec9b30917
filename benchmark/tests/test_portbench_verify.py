"""The verifier service at 2^6 on the CPU, through ``run_cell`` with the
traffic file ``traffic/verify.json``: set-up proves a proof for each
window request and one for the warm-up, the window verifies each once and
ends after the last, ``verify_s`` and the verifier's layers are reported
in the verify cells alone, and ``correct`` comes out false under the
control and with the verifier broken underneath.

``BENCHMARK.json`` has no verify cell yet: on the card, the NIZK's
verifier runs no kernel at 2^20 and the SNARK's ``verify_s`` spread
wider than a bound may allow (PERF.md).  The tests run the cells and
metrics queued for it, ``QUEUED``, as a later change would add them."""

import hashlib
import json
import os
import time
from types import SimpleNamespace as NS

import pytest

from benchmark import loop, spec
from benchmark.loop import run_cell
from benchmark.tests.helpers import SEED, prove, tiny

PROTOCOLS = ["nizk", "snark"]
CELLS = [f"{p}-2p20.verify" for p in PROTOCOLS]
QUEUED = {
    "workloads": [
        {"name": c, "config": c.split(".")[0], "traffic": "verify",
         "chips": 1, "why": "a verifier service"} for c in CELLS],
    "end_to_end": [
        {"name": "verify_s", "unit": "s", "better": "lower", "bound": 0.25,
         "source": "host_clock", "workloads": CELLS}],
    "per_layer": [
        {"name": name, "unit": unit, "better": "lower", "source": source,
         "layer": layer, "moves": "verify_s", "workloads": cells}
        for name, unit, source, layer, cells in (
            ("verify.eval_proof_s", "s", "program_span", "verifier",
             CELLS[1:]),
            ("verify.sat_proof_s", "s", "program_span", "verifier",
             CELLS[1:]),
            ("verify.eval_sparse_s", "s", "program_span", "verifier",
             CELLS[:1]),
            ("device.idle_share.verify", "%", "device_trace", "device",
             CELLS))],
}


def _with_queued(self):
    with open(os.path.join(spec.ROOT, "BENCHMARK.json")) as f:
        self.data = json.load(f)
    for key, entries in QUEUED.items():
        self.data[key] += entries


def _verify_run(protocol, trace=False, mix=None, control=None):
    """One run of the traffic ``verify`` (or ``mix``) at 2^6, with every
    proof that the adapter's ``verify`` was handed (by its bytes' hash)
    and the log."""
    seen, lines = [], []
    adapter = loop.PROTOCOLS[protocol]
    verify = adapter.verify

    def recorded(self, dep, blob, inputs):
        seen.append(hashlib.sha256(blob).hexdigest())
        return verify(self, dep, blob, inputs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(adapter, "verify", recorded)
        mp.setattr(spec.Spec, "__init__", _with_queued)
        out = run_cell(f"{protocol}-2p20.verify", SEED, 600.0, trace,
                       time.perf_counter(), device="cpu",
                       config=tiny(protocol), mix=mix, control=control,
                       log=lines.append, cache_dir=None)
    return NS(out=out, seen=seen, lines=lines)


@pytest.fixture(scope="module", params=PROTOCOLS)
def untraced(request):
    return request.param, _verify_run(request.param)


@pytest.fixture(scope="module", params=PROTOCOLS)
def traced(request):
    return request.param, _verify_run(request.param, trace=True)


def test_the_traffic_file():
    mix = spec.traffic("verify")
    assert loop.check_mix(mix) == ["verify"]
    assert (mix["setup_proofs"], mix["warmup_requests"],
            mix["checked_requests"], mix["traced_requests"]) == (16, 1, 2, 4)


def test_no_set_up_proof_is_verified_twice(untraced):
    _, r = untraced
    # the warm-up's own proof, the window's 16, the tampered ones after
    assert len(r.seen) >= 17
    assert len(set(r.seen)) == len(r.seen)


def test_the_window_ends_after_the_last_proof(untraced):
    _, r = untraced
    out = r.out
    assert out["correct"] and out["attempted"] == 16 and out["failed"] == 0
    window = [ln for ln in r.lines if ln.startswith("window ")]
    assert window and float(window[0].split()[1]) < 600.0
    assert all(c["value"] == 0 for c in out["checks"].values())


def test_verify_s_in_the_verify_cells_alone(untraced):
    _, r = untraced
    assert set(r.out["metrics"]) == {"verify_s", "peak_mem_bytes",
                                     "setup_s"}
    assert r.out["metrics"]["verify_s"]["value"] > 0
    sp = spec.Spec()
    for cell in ("nizk-2p20.prove-verify", "snark-2p20.prove-verify"):
        assert "verify_s" not in {m["name"] for m in sp.end_to_end(cell)}


def test_the_verifier_layers_on_a_traced_run(traced):
    protocol, r = traced
    assert r.out["correct"] and r.out["attempted"] == 16
    names = {"snark": {"verify.eval_proof_s", "verify.sat_proof_s"},
             "nizk": {"verify.eval_sparse_s"}}[protocol]
    # no card: nothing to read for the idle share
    assert set(r.out["metrics"]) == names
    assert all(m["value"] > 0 for m in r.out["metrics"].values())


def test_the_queued_entries_keep_the_contract(monkeypatch):
    from benchmark.tests import test_portbench_spec as t

    monkeypatch.setattr(spec.Spec, "__init__", _with_queued)
    data = spec.Spec().data
    t.test_keys_names_and_files(data)
    t.test_metrics(data)


@pytest.mark.parametrize("metric,span", [
    ("verify.eval_proof_s", "verify_eval_proof"),
    ("verify.sat_proof_s", "verify_sat_proof"),
    ("verify.eval_sparse_s", "eval_sparse_polys"),
])
def test_a_span_reader_without_its_span_reads_nothing(metric, span):
    read = spec.metric_reader(metric).read
    spans = [{span: 0.5}, {span: 1.5}]
    assert read(NS(requests=[{"verify_spans": s} for s in spans])) == 1.0
    other = NS(requests=[{"verify_spans": {"other": 1.0},
                          "prove_spans": {span: 1.0}}])
    assert read(other) is None


def test_the_idle_share_of_the_verify_calls():
    from benchmark.tests.test_portbench_trace import Ev
    from benchmark.trace import Trace

    read = spec.metric_reader("device.idle_share.verify").read
    tr = Trace([Ev("bench::verify", 0, 1000, True),
                Ev("bench::prove", 1000, 2000, True),
                Ev("msm_windows_kernel", 100, 350, False),
                Ev("fold_evals_kernel", 1200, 1900, False)])
    assert read(NS(trace=tr)) == pytest.approx(75.0)
    assert read(NS(trace=None)) is None
    assert read(NS(trace=Trace([Ev("bench::verify", 0, 10, True)]))) is None


@pytest.mark.parametrize("protocol", PROTOCOLS)
def test_the_control_fails_every_window_verify(protocol):
    r = _verify_run(protocol, control="wrong-inputs")
    out = r.out
    assert not out["correct"]
    assert out["attempted"] == 16 and out["failed"] == 16
    assert out["checks"]["failed_warmup"]["value"] == 0
    assert out["checks"]["reference_rejects"]["value"] == 2


def _accept_all(*a, **k):
    return None


def _reject_all(*a, **k):
    raise ValueError("rejected")


@pytest.mark.parametrize("where,fault,check", [
    # the answer altered where it is produced: every proof accepted, or
    # every proof rejected
    ("api.SNARK", _accept_all, "tampered_accepted"),
    ("api.SNARK", _reject_all, "failed_requests"),
    # Spark's eval-proof check skipped: the R1CS proof still holds
    ("r1cs.commit.R1CSEvalProof", _accept_all, "tampered_accepted"),
])
def test_a_broken_verifier_is_not_correct(monkeypatch, where, fault, check):
    import importlib

    mod, cls = where.rsplit(".", 1)
    target = getattr(importlib.import_module("spartan_tpu_torch." + mod), cls)
    monkeypatch.setattr(target, "verify", fault)
    r = _verify_run("snark", mix=dict(spec.traffic("verify"),
                                      setup_proofs=2))
    assert not r.out["correct"]
    assert r.out["checks"][check]["value"] >= 1


@pytest.mark.parametrize("protocol", PROTOCOLS)
def test_every_tampered_proof_is_rejected(protocol):
    p = prove(protocol)
    blobs = p.proto.tampered(p.blob)
    assert len(blobs) == {"nizk": 1, "snark": 2}[protocol]
    for b in blobs:
        assert b != p.blob
        with pytest.raises(Exception):
            p.proto.verify(p.dep, b, p.inputs)
