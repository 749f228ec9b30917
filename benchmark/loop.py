"""One run of one cell: set-up, warm-up, the measured window, the trace's
reduction and the check of ``correct``.

The port is imported inside ``run_cell``, after ``run.py`` has set the
environment (``SPARTAN_TPU_PROFILE`` is read when the port is imported).

The one request generator.  One client sends requests back to back (a
closed loop, as upstream's profilers run); a request that starts inside
the window runs to its end and counts.  A traffic mix
(``traffic/<name>.json``) sets it with data alone:

- ``steps``: what each request does, in this order, each step timed on
  its own as ``<step>_s`` and marked ``bench::<step>`` in the trace:
  ``encode``: a new circuit from (seed, request), ``Instance.new`` and
  for the SNARK ``SNARK.encode`` (without it the cell's one circuit is
  encoded once, in set-up); ``prove``: a witness for new inputs drawn
  from (seed, request), worked out on the host before the step, proved
  with a fresh transcript and random tape and serialised; ``verify``:
  deserialise and verify the request's proof, or, where the request
  proves nothing, a set-up proof of its own;
- ``setup_proofs``: in a mix that only verifies, the window's requests:
  set-up proves one proof for each, from inputs and a tape of its own,
  and one more for each warm-up request.  The window verifies each once,
  in turn, and ends after the last (a verifier checks a proof once:
  none is verified twice, so nothing computed for one proof can serve
  another);
- ``warmup_requests``: requests run in set-up, before the window;
- ``checked_requests``: proofs of the window that the reference judges,
  drawn from the seed;
- ``traced_requests``: the window's first requests, which ``--trace 1``
  runs under ``torch.profiler``.
"""

from __future__ import annotations

import contextlib
import gc
import io
import os
import random
import sys
import time
from types import SimpleNamespace as NS

import numpy as np

from . import check, spec
from .circuit import Circuit
from .reference.field import Q

LABEL = b"portbench"  # the transcript label of every proof
FORBIDDEN = ("jax", "jaxlib", "flax", "spartan_tpu")
STEPS = ("encode", "prove", "verify")
WARMUP_IDS = 1 << 40  # request ids of the warm-up, apart from the window's
SETUP_IDS = 2 << 40  # request ids of the set-up's proofs
CACHE = os.path.join(spec.ROOT, "build", "benchmark-cache", "reference")


def _tape_seed(seed: int, request: int) -> int:
    rng = np.random.default_rng([seed % (1 << 64), 2, request])
    return int.from_bytes(rng.bytes(64), "little") % Q


def _port():
    from spartan_tpu_torch import api, serialize
    from spartan_tpu_torch.core import merlin
    from spartan_tpu_torch.utils import rt, timer

    return NS(api=api, ser=serialize, Transcript=merlin.Transcript, rt=rt,
              timer=timer)


def forbidden_loaded() -> list[str]:
    """The modules of JAX or the JAX package in this process, by whole
    top-level name."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


class _Nizk:
    def __init__(self, port, conf, device):
        self.p = port
        self.gens = port.api.NIZKGens(conf["num_cons"], conf["num_vars"],
                                      conf["num_inputs"])

    def encode(self, inst) -> NS:
        return NS(inst=inst, setup=inst.digest)

    def prove(self, dep, vars_, inputs, tape) -> bytes:
        a = self.p.api
        proof = a.NIZK.prove(dep.inst, a.Assignment(vars_),
                             a.Assignment(inputs), self.gens,
                             self.p.Transcript(LABEL), _tape_seed=tape)
        return self.p.ser.nizk_to_bytes(proof)

    def verify(self, dep, blob, inputs) -> None:
        self.p.ser.nizk_from_bytes(blob).verify(
            dep.inst, self.p.api.Assignment(inputs),
            self.p.Transcript(LABEL), self.gens)

    def tampered(self, blob) -> list[bytes]:
        """The proof with one scalar of the R1CS proof changed."""
        proof = self.p.ser.nizk_from_bytes(blob)
        eq = proof.r1cs_sat_proof.proof_eq_sc_phase2
        eq.z = (eq.z + 1) % Q
        return [self.p.ser.nizk_to_bytes(proof)]


class _Snark:
    def __init__(self, port, conf, device):
        self.p, self.device = port, device
        self.gens = port.api.SNARKGens(conf["num_cons"], conf["num_vars"],
                                       conf["num_inputs"],
                                       conf["nnz_per_matrix"])

    def encode(self, inst) -> NS:
        comm, decomm = self.p.api.SNARK.encode(inst, self.gens)
        return NS(inst=inst, comm=comm, decomm=decomm,
                  setup=self.p.ser.commitment_to_bytes(comm))

    def prove(self, dep, vars_, inputs, tape) -> bytes:
        a = self.p.api
        proof = a.SNARK.prove(dep.inst, dep.comm, dep.decomm,
                              a.Assignment(vars_), a.Assignment(inputs),
                              self.gens, self.p.Transcript(LABEL),
                              _tape_seed=tape)
        return self.p.ser.snark_to_bytes(proof)

    def verify(self, dep, blob, inputs) -> None:
        self.p.ser.snark_from_bytes(blob).verify(
            dep.comm, self.p.api.Assignment(inputs),
            self.p.Transcript(LABEL), self.gens, device=self.device)

    def tampered(self, blob) -> list[bytes]:
        """The proof with one scalar changed in the R1CS proof, and
        apart in Spark's hash layer (the row memory's audit claim)."""
        out = []
        for where in ("sat", "spark"):
            proof = self.p.ser.snark_from_bytes(blob)
            if where == "sat":
                eq = proof.r1cs_sat_proof.proof_eq_sc_phase2
                eq.z = (eq.z + 1) % Q
            else:
                hl = proof.r1cs_eval_proof.proof.poly_eval_network_proof \
                    .proof_hash_layer
                addr, read_ts, audit_ts = hl.eval_row
                hl.eval_row = (addr, read_ts, (audit_ts + 1) % Q)
            out.append(self.p.ser.snark_to_bytes(proof))
        return out


PROTOCOLS = {"nizk": _Nizk, "snark": _Snark}


def check_mix(mix: dict) -> list[str]:
    """The mix's steps, in order; a mix the generator cannot run is
    refused."""
    steps = mix["steps"]
    if not steps or set(steps) - set(STEPS) or \
            list(steps) != [s for s in STEPS if s in steps]:
        raise ValueError(f"steps {steps!r}: some of {STEPS}, in that order")
    if "encode" in steps and "prove" not in steps:
        raise ValueError("a new circuit a request is there to be proved")
    if steps == ["verify"] and mix.get("setup_proofs", 0) < 1:
        raise ValueError("a mix that only verifies needs setup_proofs")
    return list(steps)


def _mean(reqs: list, key: str) -> float | None:
    """The mean over every call in the window that ran to its end."""
    vals = [r[key] for r in reqs if key in r]
    return sum(vals) / len(vals) if vals else None


def _sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool,
             t_start: float, device=None, config: dict | None = None,
             mix: dict | None = None, control: str | None = None,
             log=None, cache_dir: str | None = CACHE) -> dict:
    """Runs one cell once and returns the result (``correct``,
    ``attempted``, ``failed``, ``metrics``, ``device``, ``breakdown``
    and ``checks``).  ``config`` and ``mix`` replace the cell's
    configuration and traffic (the CPU tests' tiny sizes and other
    mixes); ``control`` breaks a guarantee on purpose: ``"wrong-inputs"``
    proves each request with the witness of other inputs than the
    request claims.  ``cache_dir`` keeps the reference's transcript
    states (``check.post_digest``)."""
    import torch

    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    sp = spec.Spec()
    cell = sp.cell(cell_name)
    conf = config or sp.config(cell["config"])
    mix = mix or spec.traffic(cell["traffic"])
    steps = check_mix(mix)
    if conf["protocol"] not in PROTOCOLS:
        raise spec.UnknownName(f"no protocol {conf['protocol']!r}")
    dev = torch.device(device or "cuda")
    port = _port()
    sizes = (conf["num_cons"], conf["num_vars"], conf["num_inputs"])

    def new_circuit(*stream) -> Circuit:
        return Circuit(*sizes, conf["circuit_seed"], *stream)

    def deploy(entries):
        inst = port.api.Instance.new(*sizes, *entries, device=dev)
        return proto.encode(inst)

    stages = [("imports", time.perf_counter())]
    proto = PROTOCOLS[conf["protocol"]](port, conf, dev)
    stages.append(("generators", time.perf_counter()))
    circuit = new_circuit()
    dep = deploy(circuit.entries())
    stages.append(("circuit, Instance.new" + (
        ", encode" if conf["protocol"] == "snark" else ""),
        time.perf_counter()))
    per_request_circuit = "encode" in steps
    # a mix that only verifies: (proof bytes, inputs) by request index
    setup_proofs = {}
    window_requests = mix["setup_proofs"] if "prove" not in steps else None
    latest = {}  # the newest request's own deployment, by request index

    def proved_witness(c: Circuit, i: int, inputs: list) -> list:
        """The witness that request ``i`` is proved with: of its own
        inputs, or under the control of other ones (warm-up apart)."""
        if control == "wrong-inputs" and i < WARMUP_IDS:
            inputs = [(inputs[0] + 1) % Q] + inputs[1:]
        return c.witness(inputs)

    def request(i: int, annotate) -> dict:
        rec = dict(index=i)

        def timed(step, fn):
            """Runs one step; keeps its time, and the port's spans,
            span totals and blocking fetches within it."""
            port.timer.records.clear()
            port.timer.totals.clear()
            f0 = port.rt.fetches
            t0 = time.perf_counter()
            with annotate("bench::" + step):
                out = fn()
                _sync(torch, dev)
            rec[step + "_s"] = time.perf_counter() - t0
            rec[step + "_fetches"] = port.rt.fetches - f0
            rec[step + "_spans"] = dict(port.timer.records)
            rec[step + "_totals"] = dict(port.timer.totals)
            return out

        try:
            _sync(torch, dev)
            cur, cur_dep = circuit, dep
            if per_request_circuit:
                cur = new_circuit(seed % (1 << 64), i)
                entries = cur.entries()
                latest.clear()
                cur_dep = timed("encode", lambda: deploy(entries))
                del entries
                latest[i] = cur_dep
                rec["circuit"], rec["setup"] = cur, cur_dep.setup
            if "prove" in steps:
                inputs = cur.inputs(seed, i)
                vars_ = proved_witness(cur, i, inputs)
                tape = _tape_seed(seed, i)
                rec.update(inputs=inputs, tape=tape)
                if trace:
                    rec["vars"] = vars_
                rec["blob"] = timed(
                    "prove", lambda: proto.prove(cur_dep, vars_, inputs,
                                                 tape))
            else:
                if i not in setup_proofs:
                    raise LookupError(f"no set-up proof for request {i}")
                rec["blob"], rec["inputs"] = setup_proofs.pop(i)
            if "verify" in steps:
                timed("verify", lambda: proto.verify(cur_dep, rec["blob"],
                                                     rec["inputs"]))
        except Exception as e:  # a failed request is counted, not fatal
            rec["error"] = f"{type(e).__name__}: {e}"[:500]
        return rec

    no_annotation = lambda _name: contextlib.nullcontext()  # noqa: E731
    quiet = contextlib.redirect_stdout(io.StringIO()) if trace else \
        contextlib.nullcontext()
    warm = []
    with quiet:
        if window_requests is not None:
            ids = list(range(window_requests)) + [
                WARMUP_IDS + k for k in range(mix["warmup_requests"])]
        else:
            ids = []
        for i in ids:
            inputs = circuit.inputs(seed, SETUP_IDS + i)
            try:
                setup_proofs[i] = (proto.prove(
                    dep, proved_witness(circuit, i, inputs), inputs,
                    _tape_seed(seed, SETUP_IDS + i)), inputs)
            except Exception as e:  # counted as a failed warm-up
                warm.append(dict(error=f"{type(e).__name__}: {e}"[:500]))
        warm += [request(WARMUP_IDS + k, no_annotation)
                 for k in range(mix["warmup_requests"])]
    for r in warm:
        if "error" in r:
            log(f"set-up request failed: {r['error']}")
    _sync(torch, dev)
    # the set-up's objects live to the end: keep them out of the
    # collector's passes during the window
    gc.collect()
    gc.freeze()
    stages.append(("warm-up", time.perf_counter()))
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s: " + ", ".join(
        f"{name} {t - t0:.3f}" for (name, t), t0 in
        zip(stages, [t_start] + [t for _, t in stages[:-1]])))
    cuda = dev.type == "cuda"
    setup_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)

    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        prof = profile(activities=acts)
        annotate = record_function
    else:
        annotate = no_annotation
    reqs = []
    with quiet:
        if prof is not None:  # the trace covers the first requests
            prof.start()
            traced = annotate("bench::window")
            traced.__enter__()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds and \
                len(reqs) != window_requests:
            reqs.append(request(len(reqs), annotate))
            if prof is not None and len(reqs) == mix["traced_requests"]:
                _sync(torch, dev)
                traced.__exit__(None, None, None)
                prof.stop()
                annotate, traced = no_annotation, None
        _sync(torch, dev)
        window_s = time.perf_counter() - t0
        if prof is not None and traced is not None:
            traced.__exit__(None, None, None)
            prof.stop()
    gc.unfreeze()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    loaded = forbidden_loaded()
    if loaded:
        raise ImportError(f"the window loaded {', '.join(loaded[:8])}")
    done = [r for r in reqs if "error" not in r]
    failed = len(reqs) - len(done)
    for r in reqs:
        log(f"request {r['index']}: " + (
            f"failed: {r['error']}" if "error" in r else ", ".join(
                f"{s} {r[s + '_s']:.4f} s" for s in steps)))
    log(f"window {window_s:.3f} s: {len(reqs)} requests, {failed} failed")

    run = NS(cell=cell, config=conf, mix=mix, seed=seed, requests=done,
             traced=[r for r in reqs[:mix["traced_requests"]]
                     if "error" not in r] if trace else [],
             trace=None, protocol=conf["protocol"], window_s=window_s)
    out = dict(correct=False, attempted=len(reqs), failed=failed)
    dev_info = dict(platform="gpu" if cuda else dev.type,
                    kind=torch.cuda.get_device_name(dev) if cuda else "cpu",
                    count=1, memory_peak_bytes=max(setup_peak, peak))
    if trace:
        from .trace import Trace

        t0 = time.perf_counter()
        tr = Trace(prof.profiler.kineto_results.events())
        del prof
        log(f"trace: {len(tr.dev)} device and {len(tr.cpu)} host events "
            f"reduced in {time.perf_counter() - t0:.1f} s")
        run.trace = tr
        dev_info["busy_s"] = tr.busy_s("bench::window")
        dev_info["window_s"] = tr.span_s("bench::window")
        out["breakdown"] = dict(
            device_ops=tr.top_device_ops("bench::window"),
            idle_gaps=tr.idle_by_host("bench::window"))
        metrics = {}
        for m in sp.per_layer(cell_name):
            v = spec.metric_reader(m["name"]).read(run)
            if v is not None:
                metrics[m["name"]] = dict(value=v, unit=m["unit"])
    else:
        e2e = {s + "_s": _mean(reqs, s + "_s") for s in steps}
        e2e.update(peak_mem_bytes=peak, setup_s=setup_s)
        metrics = {m["name"]: dict(value=e2e[m["name"]], unit=m["unit"])
                   for m in sp.end_to_end(cell_name)
                   if e2e.get(m["name"]) is not None}
    out["metrics"] = metrics
    out["device"] = dev_info

    # correct: the program's verifier on a tampered proof, then the
    # reference on a sample drawn from the seed
    rng = random.Random(seed * 1000003 + 17)
    proved = list({r["blob"]: r for r in reversed(reqs)
                   if "blob" in r}.values())  # each proof once
    pick = sorted(rng.sample(sorted(proved, key=lambda r: r["index"]),
                             min(mix["checked_requests"], len(proved))),
                  key=lambda r: r["index"])
    tampered_accepted = 0
    mine = [(r, latest.get(r["index"], dep)) for r in done
            if not per_request_circuit or r["index"] in latest]
    if mine:
        r, d = mine[0]
        for blob in proto.tampered(r["blob"]):
            try:
                proto.verify(d, blob, r["inputs"])
                tampered_accepted += 1
            except Exception:  # rejected, as it must be
                pass
    base_setup = dep.setup
    del dep, mine, setup_proofs
    latest.clear()
    groups = []
    for r in pick:
        c, setup = r.get("circuit", circuit), r.get("setup")
        if groups and groups[-1][0] is c:
            groups[-1][2].append((r["blob"], r["inputs"]))
        else:
            groups.append((c, setup, [(r["blob"], r["inputs"])]))
    t0 = time.perf_counter()
    ref = check.judge(conf["protocol"], [
        (c, setup if setup is not None else base_setup, s)
        for c, setup, s in groups], LABEL, seed, cache_dir)
    log(f"reference: {len(pick)} proofs in {time.perf_counter() - t0:.3f} s")
    checks = dict(failed_requests=(failed, 0),
                  failed_warmup=(sum("error" in r for r in warm), 0),
                  reference_rejects=(ref["reference_rejects"], 0),
                  setup_mismatch=(ref["setup_mismatch"], 0),
                  tampered_accepted=(tampered_accepted, 0),
                  zk_unblinded=(ref["zk_unblinded"], 0),
                  zk_blind_repeats=(ref["zk_blind_repeats"], 0),
                  unchecked=(0 if pick else 1, 0))
    out["correct"] = all(v <= lim for v, lim in checks.values())
    out["checks"] = {k: dict(value=v, limit=lim)
                     for k, (v, lim) in checks.items()}
    return out
