"""The whole loop of a run, at 2^6 on the CPU (``device="cpu"``; the
result is not recorded), and ``correct`` coming out false when the timed
path is broken underneath: a step that returns its state unchanged, half
of a batch left out, an answer altered where it is produced, a witness
commitment left unblinded, and the control (a proof for other inputs
than claimed).  The cell has one chip, so no exchange between chips can
be left out.  The generator runs the other mixes that its data can ask
for, and refuses one it cannot run."""

import time

import pytest
import torch

from benchmark.loop import check_mix, run_cell
from benchmark.tests.helpers import SEED, tiny


def _run(protocol, **kw):
    kw.setdefault("log", lambda m: None)
    return run_cell(f"{protocol}-2p20.prove-verify", SEED, 0.2, False,
                    time.perf_counter(), device="cpu",
                    config=tiny(protocol), cache_dir=None, **kw)


def test_a_whole_run_is_correct():
    out = _run("nizk")
    assert out["correct"] and out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {"prove_s", "peak_mem_bytes", "setup_s"}
    assert list(out)[-1] == "checks"
    assert all(c["value"] == 0 for c in out["checks"].values())


def test_a_traced_run_reads_the_span_metrics():
    out = run_cell("nizk-2p20.prove-verify", SEED, 0.2, True,
                   time.perf_counter(), device="cpu", config=tiny("nizk"),
                   log=lambda m: None, cache_dir=None)
    assert out["correct"]
    m = out["metrics"]
    assert {"r1cs.phase_one_s", "r1cs.polycommit_s", "rt.fetches"} <= set(m)
    # no card: nothing to read for the device's metrics
    assert not {"kernels.fold_evals_roofline", "kernels.row_msm_roofline",
                "device.idle_share.prove"} & set(m)
    assert "busy_s" in out["device"] and "window_s" in out["device"]


def test_a_step_that_returns_its_state_unchanged(monkeypatch):
    from spartan_tpu_torch.ff import round_kernel as rk

    plain = rk.fold_evals_plain

    def unchanged(tables, r, mode):
        outs, evals = plain(tables, r, mode)
        if mode == "evals":
            return outs, evals
        half = tables[0].shape[-2] // 2
        return [t[..., :half, :].clone() for t in tables], evals

    monkeypatch.setattr(rk, "fold_evals_plain", unchanged)
    out = _run("nizk")
    assert not out["correct"]


def test_half_of_the_rows_left_out(monkeypatch):
    from spartan_tpu_torch.curve import row_msm as rm

    plain = rm.row_msm_plain

    def half(scalars, tab):
        out = plain(scalars, tab)
        L = out.shape[0]
        if L >= 2:
            out[L // 2:] = out[: L - L // 2]
        return out

    monkeypatch.setattr(rm, "row_msm_plain", half)
    assert not _run("nizk")["correct"]


def test_half_of_the_batch_left_out(monkeypatch):
    from spartan_tpu_torch.ff import round_kernel as rk

    plain = rk.fold_evals_plain

    def half(tables, r, mode):
        if len(tables) == 3 and tables[0].shape[0] >= 2:
            b = tables[0].shape[0]
            tables = [torch.cat([t[: b - b // 2], t[: b // 2]])
                      for t in tables]
        return plain(tables, r, mode)

    monkeypatch.setattr(rk, "fold_evals_plain", half)
    assert not _run("snark")["correct"]


def test_an_answer_altered_where_it_is_produced(monkeypatch):
    """The proof bytes altered as they are written, and the program's
    verifier accepting everything: the reference alone must catch it."""
    from spartan_tpu_torch import api, serialize

    write = serialize.nizk_to_bytes

    def altered(nizk):
        eq = nizk.r1cs_sat_proof.proof_eq_sc_phase1
        eq.z = (eq.z + 1) % (2**252 + 27742317777372353535851937790883648493)
        return write(nizk)

    monkeypatch.setattr(serialize, "nizk_to_bytes", altered)
    monkeypatch.setattr(api.NIZK, "verify", lambda *a, **k: None)
    out = _run("nizk")
    assert not out["correct"]
    assert out["failed"] == 0 and out["checks"]["reference_rejects"][
        "value"] >= 1


def test_a_witness_commitment_left_unblinded(monkeypatch):
    from spartan_tpu_torch.core import merlin

    draw = merlin.RandomTape.random_vector

    def zero_blinds(self, label, n):
        out = draw(self, label, n)
        return [0] * n if label == b"poly_blinds" else out

    monkeypatch.setattr(merlin.RandomTape, "random_vector", zero_blinds)
    out = _run("snark")
    assert not out["correct"] and out["failed"] == 0
    assert out["checks"]["zk_unblinded"]["value"] >= 1


MIXES = {
    "verify-only": dict(steps=["verify"], setup_proofs=2),
    "encode-prove-verify": dict(steps=["encode", "prove", "verify"]),
}


@pytest.mark.parametrize("protocol", ["nizk", "snark"])
@pytest.mark.parametrize("mix", sorted(MIXES))
def test_other_mixes_run_from_data_alone(protocol, mix):
    lines = []
    out = _run(protocol, log=lines.append,
               mix=dict(MIXES[mix], warmup_requests=1, checked_requests=2,
                        traced_requests=1))
    assert out["correct"] and out["attempted"] >= 1
    steps = MIXES[mix]["steps"]
    for s in ("encode", "prove", "verify"):
        timed = [ln for ln in lines if ln.startswith("request ")
                 and f" {s} " in ln]
        assert bool(timed) == (s in steps), (s, lines)
    assert ("prove_s" in out["metrics"]) == ("prove" in steps)


@pytest.mark.parametrize("steps", [[], ["prove", "encode"], ["sign"],
                                   ["encode", "verify"], ["verify"]])
def test_a_mix_the_generator_cannot_run_is_refused(steps):
    with pytest.raises(ValueError):
        check_mix(dict(steps=steps, setup_proofs=0))


@pytest.mark.parametrize("protocol", ["nizk", "snark"])
def test_the_control_proves_other_inputs(protocol):
    out = _run(protocol, control="wrong-inputs")
    assert not out["correct"]
    assert out["checks"]["reference_rejects"]["value"] >= 1


@pytest.mark.cuda
def test_a_whole_run_on_the_card(cuda_device):
    out = run_cell("nizk-2p20.prove-verify", SEED, 0.5, True,
                   time.perf_counter(), device=cuda_device,
                   config=dict(tiny("nizk"), num_cons=1024, num_vars=1024,
                               nnz_per_matrix=1024), log=lambda m: None,
                   cache_dir=None)
    assert out["correct"]
    assert out["device"]["busy_s"] > 0
    assert 0 < out["metrics"]["kernels.fold_evals_roofline"]["value"] <= 105
    assert 0 < out["metrics"]["kernels.row_msm_roofline"]["value"] <= 105
