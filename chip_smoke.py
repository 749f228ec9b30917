#!/usr/bin/env python3
"""Start the PyTorch/CUDA port (``spartan_tpu_torch``) on one NVIDIA card
and check it end to end.

    python3 chip_smoke.py

In order: the card's name and power limit; the CUDA kernels built from
``spartan_tpu_torch/csrc`` with ``-Xptxas -v`` (registers and spills
printed per entry function); each kernel held bit for bit against its
plain PyTorch version on the card, at small shapes, at the shapes the
NIZK path gives it and at the one-row (1, 4096) of ``vmsm``; B1's window
and combine stages timed apart, and its bound counted on the run's
scalars (non-zero digits only); B2's three modes at (4, 2^20) timed in
a CUDA graph and launched one by one; B2 along the two whole round chains of
a 2^20 prove (21 cubic launches from 4 x 2^20, 22 quad launches from
2 x 2^21), checked against the plain version round by round and timed,
with the per-prove total beside the summed bound; the golden NIZK at
(16, 16, 2) equal to ``tests/golden/nizk_proof.bin`` and its digest to
``tests/golden/instance_digest.bin``; a NIZK at
2^20 constraints and variables with 10 inputs proved, verified and a
tampered copy rejected, with every launch counter reset just before and
read just after and the prove's cudaMalloc calls counted; one more 2^20
witness commitment under ``torch.profiler`` (its kernels' device time).
Then the SNARK slice: B1 against its plain version at (8, 4096),
(64, 2048) and (2048, 2048); B2's batched 3-table (cubic_prod) mode
against its plain version at (2, 4), (6, 64), (18, 4096), (18, 2^19),
(12, 2^18) and (4, 2^20) in all modes, timed at (18, 2^19) in a CUDA
graph beside its bound; the golden SNARK commitment and proof equal
``tests/golden/``; a SNARK on the NIZK's 2^20 instance encoded, proved,
verified and a tampered copy rejected, each of encode and prove between
counter resets, the first, middle and last rows of each of their B1
launches held against the plain version, with B1 timed on the encode's
own tables; then the prove's batched B2 launches, as counted by shape,
replayed and timed.  Then an empty kernel's time a launch, in a CUDA
graph and launched one by one (the launch floor); K3, one STROBE step
(``csrc/keccak.cu``, one Keccak lane a warp lane), against its plain
version on 1,024 random states in seven forms (three segments with and
without a mask and the permutation, 16 adjacent segments, segments at
odd offsets), timed beside the launch floor; one field product's and
one squaring's latency on K4's group of 8 lanes beside the one-lane
product's (``fp latency ...``); K4, the ristretto encode
(``csrc/ristretto.cu``, 8 lanes a point), on 4,097 points that cover
every branch of ENCODE and on the last 1, 3 and 33 of them, timed
beside its bound, its chain floor (251 squarings and 33 products at the
group's latencies, and 284 products at the one-lane product's) and the
launch floor; B2 reading its
challenge through a pointer against the by-value form at (4, 2^20),
(2, 2^21) and (18, 2^19), in both modes that take a challenge; and the
same 2^20 NIZK and SNARK proved again under the gate, whose bytes must
equal the host path's and verify, each device ZK phase, product proof
and dot-product-log proof fetching once, and B1 launched there only as
often as on the host path (never with the ZK rounds' tape secrets).
The bullet rounds' kernels: one field product's latency from a
one-thread chain of them; K5, the grouped variable-base MSM
(``csrc/point_msm.cu``, a quad of lanes a point), against its plain
version bit for bit at the path's shapes (K5_CASES: the cross terms of
the first rounds at n = 2,048 and 4,096, Cx at 4,096, G folds of 1,024
and 2,048 pairs, a ZK round's 5 groups of 7, and 11 points with edge
scalars and the identity point), each timed launched one by one and in
a CUDA graph beside its bound, its chain floor and the time of its
earlier one-thread-a-point design; K6, the
bullet round's scalar step (``csrc/bullet_step.cu``), in every mode at
n = 1,024, 2,048 and 4,096, the fold also at u = 1, q - 1 and 2^200;
the elementwise Fq kernel's Montgomery map (``csrc/fq_elementwise.cu``)
against its plain version at 1, 5, 513 and 2^20 elements, also into a
slice of a larger table, timed at 2^20 beside its bound;
forced launch failures of K5 and K4 and forced build failures of K6
and K3, each of which must raise with no plain version run in its
place; then a host round and a device round timed at n = 2^1 ... 2^12
(``bullet round n ...`` lines: the walls that set
``protocols/bullet.py::DEVICE_MIN``), each device round fetching once;
the default path's launches of K5 and K6 in each prove;
and after the default path's 2^20 NIZK and SNARK (now with device
rounds) both proved again in the same process with every round on the
host (``host_rounds {...}``), for the same bytes.  Then the
multi-device prover (``parallel/``): the 2^20 NIZK proved and the SNARK
encoded and proved once more under a mesh that lists the card 4 times,
each shard a launch of B1 or B2 at its own size (``sharded {...}``: the
bytes equal the default path's and verify, sharded rounds counted in
phase one, phase two and the product layers, walls, spans, launches and
peak memory beside the default path's, B1's launches held against the
plain version on their first, middle and last rows, B1 and B2 bit for
bit at the first sharded shapes, 4 launches at n/4 timed beside one at
n); and the two-tier collectives on the card listed 8 times as (2
hosts, 4 devices) against python ints and the host MSM (``dcn
{...}``).  It ends with a JSON line per kernel (B2's batched mode its
own line, K3, K4, K5, K6 and the Montgomery map theirs), the card's line from nvidia-smi
and ``{"ok": true, "device": {...}}``.  Any failure raises and exits
non-zero; with no card it exits 2 before printing any result.  All inputs are made from fixed
seeds.
"""

from __future__ import annotations

import collections
import concurrent.futures
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
# per-phase times synchronise only under profiling (utils/timer.py)
os.environ.setdefault("SPARTAN_TPU_PROFILE", "1")

# H100 SXM peaks: HBM bytes/s, and 32-bit integer multiply-adds/s
# (132 SMs x 64 IMAD a clock x 1.98 GHz boost clock)
HBM_BYTES_S = 3.35e12
IMAD_S = 132 * 64 * 1.98e9
# a 32x32->64-bit multiply-add issues as two IMAD slots (low and high)
IMAD_PER_WIDE = 2
FP_MUL_WIDE = 64 + 8  # 8x8 schoolbook products + the 38-fold of 8 words
FQ_MUL_WIDE = 64 + 64 + 8  # CIOS: a*b, m*q and the m words
# the reference's flagship instance (BASELINE.md): 2^20 constraints and
# variables, 10 inputs
LOG_N = 20


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` launches (one warm-up)."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def graph_ms(fn, reps: int) -> float:
    """Mean device time of ``fn``'s launches captured in a CUDA graph and
    replayed ``reps`` times: the launches back to back, without the host's
    gaps between them."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(graph.replay, reps)


def max_abs_err(a, b) -> int:
    """Largest absolute difference of the int32 words (0 when equal)."""
    return int((a.long() - b.long()).abs().max())


def build_kernels() -> None:
    from spartan_tpu_torch import _build

    def timed(name):
        t0 = time.perf_counter()
        path, report = _build.compile_kernel(name, verbose=True)
        return path, report, time.perf_counter() - t0

    names = ["row_msm", "fold_evals", "keccak", "ristretto", "point_msm",
             "bullet_step", "fq_elementwise"]
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        futs = {n: pool.submit(timed, n) for n in names}
        for name in names:
            path, report, secs = futs[name].result()
            log(f"built {name} in {secs:.1f} s: "
                f"{os.path.relpath(path, REPO)}")
            for line in report.splitlines():
                if ("registers" in line or "spill" in line
                        or "entry function" in line):
                    log(f"  ptxas {name}: {line.strip()}")


def rand_elems(gen, n: int, device):
    """(n, 8) int32 values below 2^252 < q: canonical scalars and valid
    Montgomery residues alike."""
    import torch

    w = torch.randint(-(1 << 31), 1 << 31, (n, 8), generator=gen,
                      dtype=torch.int64).to(torch.int32)
    w[:, 7] &= 0x0FFFFFFF
    return w.to(device)


def with_edges(t, edges):
    from spartan_tpu_torch.ff import limb

    k = min(len(edges), t.shape[0])
    t[:k] = limb.ints_to_limbs(edges[:k], t.device)
    return t


# the shapes each kernel is checked at: B1's include the witness rows at
# 2^20, the one row of vmsm, Spark's generator counts (4096, 2048) at
# fewer rows and the whole comb_mem commitment of a 2^20 SNARK (2048,
# 2048); B2's last ones are phase one's tables at 2^20 and phase two's
# at 2^21
MSM_SHAPES = [(4, 16), (3, 20), (2, 24), (1024, 1), (1024, 1024), (1, 4096),
              (8, 4096), (64, 2048), (2048, 2048)]
ROUND_CASES = [(4, 8), (4, 64), (4, 4096), (2, 8), (2, 256), (4, 1 << 20),
               (2, 1 << 21)]
MSM_TIMED = (1024, 1024)
# B1's launches in a 2^20 prove: the witness rows and the blinds times h
MSM_PER_PROVE = [(1024, 1024), (1024, 1)]
ROUND_TIMED = (4, 1 << 20, "fold_evals")
# B2's round chains in a 2^20 prove: (tables, log2 of the first size)
ROUND_CHAINS = [(4, LOG_N), (2, LOG_N + 1)]


def check_row_msm(dev, gen, shapes) -> dict:
    """B1 against its plain version at ``shapes``; times at MSM_TIMED."""
    import torch

    from spartan_tpu_torch.commitments import MultiCommitGens
    from spartan_tpu_torch.core.field import Q
    from spartan_tpu_torch.curve import row_msm as rm

    result, per_prove = {}, {}
    for L, R in shapes:
        gens = MultiCommitGens(R, b"chip_smoke")
        tab = gens.msm_table(dev)
        s = with_edges(rand_elems(gen, L * R, dev), [0, 1, 2, 15, 16, Q - 1])
        s = s.reshape(L, R, 8)
        t0 = time.perf_counter()
        want = rm.row_msm_plain(s, tab)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        got = rm.row_msm(s, tab)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        log(f"row_msm (L, R) = ({L}, {R}): max_abs_err {err}, plain "
            f"{plain_ms:.1f} ms")
        if err != 0:
            raise AssertionError(f"row_msm differs from its plain version "
                                 f"at ({L}, {R})")
        if (L, R) in MSM_PER_PROVE:
            per_prove[(L, R)] = (cuda_ms(lambda: rm.row_msm(s, tab), 3),
                                 row_msm_bound(s)["bound_ms"])
        if (L, R) == MSM_TIMED:
            ms = per_prove[(L, R)][0]
            win_ms, comb_ms = row_msm_stage_ms(s, tab, 3)
            bound = row_msm_bound(s)
            log(f"row_msm ({L}, {R}): {ms:.3f} ms = windows {win_ms:.3f} "
                f"ms + combine {comb_ms:.3f} ms; bound "
                f"{bound['bound_ms']:.3f} ms ({bound['bound_by']}; "
                f"{bound['full_digits_bound_ms']:.3f} ms counting the "
                f"zero digits)")
            result = dict(shape=[L, R], ms=ms, plain_ms=plain_ms,
                          max_abs_err=err, windows_ms=win_ms,
                          combine_ms=comb_ms, **bound)
    if per_prove:
        result["ms_per_prove"] = sum(v[0] for v in per_prove.values())
        result["bound_ms_per_prove"] = sum(v[1] for v in per_prove.values())
        log(f"row_msm per 2^20 prove ({len(per_prove)} launches): "
            f"{result['ms_per_prove']:.3f} ms, bound "
            f"{result['bound_ms_per_prove']:.3f} ms")
    return result


def row_msm_stage_ms(scalars, tab, reps: int) -> tuple[float, float]:
    """B1's window stage and combine stage, each timed on the device (mean
    over ``reps`` runs of one whole MSM), through the kernel library's
    timing entry ``row_msm_stage_ms``; the launches are not counted."""
    import ctypes

    import torch

    from spartan_tpu_torch import _build
    from spartan_tpu_torch.curve import row_msm as rm
    from spartan_tpu_torch.ff import limb

    lib = _build.load("row_msm", rm._declare)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.row_msm_stage_ms.argtypes = [p, p, p, p, i, i, i, p,
                                     ctypes.POINTER(ctypes.c_float)]
    lib.row_msm_stage_ms.restype = i
    L, R = scalars.shape[:2]
    S = rm.segments(L, R)
    dev = scalars.device
    part = torch.empty((L, S, rm.NWINDOWS, 4, limb.NWORDS),
                       dtype=torch.int32, device=dev)
    out = torch.empty((L, 4, limb.NWORDS), dtype=torch.int32, device=dev)
    want = rm.row_msm(scalars, tab)
    total = [0.0, 0.0]
    for k in range(reps + 1):  # the first is a warm-up
        ms = (ctypes.c_float * 2)()
        _build.check(lib.row_msm_stage_ms(
            scalars.data_ptr(), tab.data_ptr(), part.data_ptr(),
            out.data_ptr(), L, R, S, _build.stream_handle(dev), ms),
            "row_msm_stage_ms")
        if k:
            total = [total[0] + ms[0], total[1] + ms[1]]
    if not torch.equal(out, want):
        raise AssertionError("row_msm_stage_ms differs from row_msm")
    return total[0] / reps, total[1] / reps


def row_msm_bound(scalars) -> dict:
    """The least work for the same function with 4-bit windows, counted
    on these scalars: a mixed add against the precomputed (y+x, y-x,
    2d*x*y) table with Z = 1 (7 field products, 96 B an entry) for each
    non-zero digit; per row, from its top non-zero window down, 4
    doublings (8 products each) a window and a unified add (9) for each
    lower window that has a non-zero digit.  ``full_digits_bound_ms``
    counts every digit and window (zero ones too), as PR 1's bound
    did."""
    import torch

    from spartan_tpu_torch.curve import row_msm as rm

    L, R = scalars.shape[:2]
    nz = rm._digits(scalars) != 0  # (L, R, 64)
    madds = int(nz.sum())
    win = nz.any(dim=1)  # (L, 64): windows with a non-zero digit
    w = torch.arange(rm.NWINDOWS, device=scalars.device)
    top = torch.where(win, w, -1).max(dim=1).values  # (L,)
    dbls = 4 * int(top.clamp(min=0).sum())
    adds = int((win & (w < top[:, None])).sum())
    bytes_ = L * R * 32 + 16 * R * 96 + L * 128

    def ms(madds, adds, dbls):
        wide = (madds * 7 + adds * 9 + dbls * 8) * FP_MUL_WIDE
        return (bytes_ / HBM_BYTES_S * 1e3,
                wide * IMAD_PER_WIDE / IMAD_S * 1e3)

    t_bytes, t_ops = ms(madds, adds, dbls)
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes > t_ops else "operations",
                full_digits_bound_ms=max(ms(64 * L * R, 63 * L,
                                            252 * L)))


def fold_evals_bound(ntab: int, n: int, mode: str, batch: int = 1) -> dict:
    """Bytes: each input read once, each output written once.  Ops: the
    Montgomery products (2 per pair per table to fold, the comb's
    products at 3 points for the cubic combs, 2 for quad).  ``batch``
    instances of ``n`` each."""
    out = n // 2 if mode != "evals" else 0
    bytes_ = batch * (ntab * n * 32 + ntab * out * 32 + 96)
    pairs = batch * (n // 4 if mode == "fold_evals" else n // 2)
    folds = 2 * ntab * pairs if mode == "fold_evals" else (
        ntab * pairs if mode == "fold" else 0)
    combs = 0 if mode == "fold" else pairs * (2 if ntab == 2 else 6)
    wide = (folds + combs) * FQ_MUL_WIDE
    t_bytes = bytes_ / HBM_BYTES_S * 1e3
    t_ops = wide * IMAD_PER_WIDE / IMAD_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes > t_ops else "operations")


def check_fold_evals(dev, gen, cases) -> dict:
    """B2 against its plain version in all modes and along a chain of
    rounds at ``cases`` (ntab, n); times at ROUND_TIMED."""
    import torch

    from spartan_tpu_torch.core.field import Q
    from spartan_tpu_torch.ff import round_kernel as rk

    r = [123456789, Q - 1, 3 ** 150 % Q]
    result = {}
    for ntab, n in cases:
        tabs = [with_edges(rand_elems(gen, n, dev), [0, Q - 1, 1])
                for _ in range(ntab)]
        for mode in ("evals", "fold_evals", "fold"):
            rr = None if mode == "evals" else r[n % 3]
            t0 = time.perf_counter()
            want_t, want_e = rk.fold_evals_plain(tabs, rr, mode)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            got_t, got_e = rk.fold_evals(tabs, rr, mode)
            torch.cuda.synchronize()
            err = max(max_abs_err(a, b) for a, b in zip(got_t, want_t))
            if mode != "fold":
                err = max(err, max_abs_err(got_e, want_e))
            log(f"fold_evals ntab {ntab} n {n} {mode}: max_abs_err {err}")
            if err != 0:
                raise AssertionError(
                    f"fold_evals differs from its plain version at ntab "
                    f"{ntab}, n {n}, mode {mode}")
            if (ntab, n) == ROUND_TIMED[:2]:
                # device time from a CUDA graph of 10 launches: launched
                # one by one from Python, a launch of ~0.1 ms can wait on
                # the host
                ms = graph_ms(lambda: [rk.fold_evals(tabs, rr, mode)
                                       for _ in range(10)], 5) / 10
                eager = cuda_ms(lambda: rk.fold_evals(tabs, rr, mode), 20)
                bound = fold_evals_bound(ntab, n, mode)
                log(f"fold_evals ntab {ntab} n {n} {mode}: {ms:.4f} ms in a "
                    f"CUDA graph ({eager:.4f} ms launched one by one), bound "
                    f"{bound['bound_ms']:.4f} ms ({bound['bound_by']})")
            if (ntab, n, mode) == ROUND_TIMED:
                result = dict(shape=[ntab, n, mode], ms=ms, eager_ms=eager,
                              plain_ms=plain_ms, max_abs_err=err, **bound)
        # a two-round chain: round 0 evals, then fold_evals twice, then
        # the last fold, each fed the previous outputs
        if n >= 16:
            want, got = tabs, tabs
            for mode, rr in (("fold_evals", r[0]), ("fold_evals", r[1]),
                             ("fold", r[2])):
                want, we = rk.fold_evals_plain(want, rr, mode)
                got, ge = rk.fold_evals(got, rr, mode)
                err = max(max_abs_err(a, b) for a, b in zip(got, want))
                if mode != "fold":
                    err = max(err, max_abs_err(ge, we))
                if err != 0:
                    raise AssertionError(f"fold_evals chain differs at "
                                         f"ntab {ntab}, n {n}")
            log(f"fold_evals chain ntab {ntab} n {n}: max_abs_err 0")
    return result


# the elementwise Fq kernel's Montgomery map: small and ragged sizes, and
# the witness of a 2^20 prove (timed); TO_MONT_SETS tables in turn, so
# that every timed launch reads its input from device memory, not L2
TO_MONT_CASES = [1, 5, 513, 1 << LOG_N]
TO_MONT_SETS = 4


def to_mont_bound(n: int) -> dict:
    """Bytes: n elements read and n written; ops: one Montgomery product
    an element."""
    t_bytes = n * 64 / HBM_BYTES_S * 1e3
    t_ops = n * FQ_MUL_WIDE * IMAD_PER_WIDE / IMAD_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes > t_ops else "operations")


def check_to_mont(dev, gen) -> dict:
    """The elementwise kernel's TO_MONT mode (``fq.to_mont``) against its
    plain version at TO_MONT_CASES, with 0, 1, q - 1 and 2^252 among the
    values, and into a slice of a larger table as z takes the witness;
    timed at 2^LOG_N in a CUDA graph and launched one by one."""
    import torch

    from spartan_tpu_torch.core.field import Q
    from spartan_tpu_torch.ff import fq

    result = {}
    for n in TO_MONT_CASES:
        a = with_edges(rand_elems(gen, n, dev), [1 << 252, 0, 1, Q - 1])
        t0 = time.perf_counter()
        want = fq.to_mont_plain(a)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        z = rand_elems(gen, 2 * n + 1, dev)
        keep = z.clone()
        fq.to_mont(a, out=z[1:n + 1])
        torch.cuda.synchronize()
        err = max(max_abs_err(fq.to_mont(a), want),
                  max_abs_err(z[1:n + 1], want))
        torch.cuda.synchronize()
        if err != 0 or not (torch.equal(z[:1], keep[:1])
                            and torch.equal(z[n + 1:], keep[n + 1:])):
            raise AssertionError(f"to_mont differs from its plain version "
                                 f"at n {n}, or wrote outside its slice")
        log(f"to_mont n {n}: max_abs_err {err}, plain {plain_ms:.2f} ms")
        if n == TO_MONT_CASES[-1]:
            ins = [a] + [rand_elems(gen, n, dev)
                         for _ in range(TO_MONT_SETS - 1)]
            outs = [torch.empty_like(x) for x in ins]

            def launches():
                for x, o in zip(ins, outs):
                    fq.to_mont(x, out=o)

            ms = graph_ms(launches, 10) / TO_MONT_SETS
            eager = cuda_ms(launches, 10) / TO_MONT_SETS
            bound = to_mont_bound(n)
            log(f"to_mont n {n}: {ms:.4f} ms in a CUDA graph ({eager:.4f} "
                f"ms launched one by one), bound {bound['bound_ms']:.4f} ms "
                f"({bound['bound_by']}), plain {plain_ms:.2f} ms")
            result = dict(shape=[n], ms=ms, eager_ms=eager,
                          plain_ms=plain_ms, max_abs_err=err, **bound)
    return result


def round_chain(fold, tabs, rs):
    """One sum-check phase's launches: evals, then fold_evals per round,
    the last round a fold.  Returns every round's outputs."""
    outs = [fold(tabs, None, "evals")]
    for k, r in enumerate(rs):
        mode = "fold_evals" if k + 1 < len(rs) else "fold"
        outs.append(fold(outs[-1][0], r, mode))
    return outs


def round_chain_bound(ntab: int, log_n: int) -> float:
    n = 1 << log_n
    return (fold_evals_bound(ntab, n, "evals")["bound_ms"]
            + sum(fold_evals_bound(ntab, n >> k, "fold_evals")["bound_ms"]
                  for k in range(log_n - 1))
            + fold_evals_bound(ntab, 2, "fold")["bound_ms"])


def check_round_chains(dev, gen) -> dict:
    """B2 along the whole round chains of a 2^20 prove: bit for bit
    against the plain version after every round, then timed."""
    from spartan_tpu_torch.core.field import Q
    from spartan_tpu_torch.ff import round_kernel as rk

    total_ms = total_eager = total_bound = 0.0
    result = {}
    for ntab, log_n in ROUND_CHAINS:
        tabs = [rand_elems(gen, 1 << log_n, dev) for _ in range(ntab)]
        rs = [(7 ** (k + 40)) % Q for k in range(log_n)]
        got = round_chain(rk.fold_evals, tabs, rs)
        want = round_chain(rk.fold_evals_plain, tabs, rs)
        for k, ((gt, ge), (wt, we)) in enumerate(zip(got, want)):
            err = max(max_abs_err(a, b) for a, b in zip(gt, wt))
            if ge is not None or we is not None:
                err = max(err, max_abs_err(ge, we))
            if err != 0:
                raise AssertionError(f"fold_evals chain ntab {ntab} from "
                                     f"2^{log_n} differs at launch {k}")
        del got, want
        eager = cuda_ms(lambda: round_chain(rk.fold_evals, tabs, rs), 5)
        ms = graph_ms(lambda: round_chain(rk.fold_evals, tabs, rs), 5)
        bound = round_chain_bound(ntab, log_n)
        log(f"fold_evals chain ntab {ntab} from 2^{log_n}: {log_n + 1} "
            f"launches, max_abs_err 0, {ms:.3f} ms in a CUDA graph "
            f"({eager:.3f} ms launched one by one), bound {bound:.3f} ms")
        result[f"chain_{ntab}x2^{log_n}_ms"] = ms
        total_ms += ms
        total_eager += eager
        total_bound += bound
    log(f"fold_evals per 2^20 prove: {total_ms:.3f} ms in CUDA graphs "
        f"({total_eager:.3f} ms launched one by one), bound "
        f"{total_bound:.3f} ms")
    result.update(ms_per_prove=total_ms, eager_ms_per_prove=total_eager,
                  bound_ms_per_prove=total_bound)
    return result


# B2's batched 3-table (cubic_prod) mode: (instances, size) checked; the
# last three are layers of a 2^20 SNARK's product proofs: the ops
# circuits' layer 0 (12 product and 6 dot-product circuits of 2^19
# pairs), a later ops layer (12 circuits) and the mem circuits' layer 0
# (4 circuits of 2^20 pairs)
PROD_CASES = [(2, 4), (6, 64), (18, 4096), (18, 1 << 19), (12, 1 << 18),
              (4, 1 << 20)]
PROD_TIMED = (18, 1 << 19)


def check_cubic_prod(dev, gen, cases=PROD_CASES) -> dict:
    """B2's batched mode against its plain version in all three modes at
    ``cases``; each mode timed at PROD_TIMED in a CUDA graph."""
    import torch

    from spartan_tpu_torch.core.field import Q
    from spartan_tpu_torch.ff import round_kernel as rk

    result = {}
    for batch, n in cases:
        tabs = [with_edges(rand_elems(gen, batch * n, dev), [0, Q - 1, 1])
                .reshape(batch, n, 8) for _ in range(3)]
        for mode in ("evals", "fold_evals", "fold"):
            rr = None if mode == "evals" else (5 ** 101) % Q
            t0 = time.perf_counter()
            want_t, want_e = rk.fold_evals_plain(tabs, rr, mode)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            got_t, got_e = rk.fold_evals(tabs, rr, mode)
            torch.cuda.synchronize()
            err = max(max_abs_err(a, b) for a, b in zip(got_t, want_t))
            if mode != "fold":
                err = max(err, max_abs_err(got_e, want_e))
            del want_t, got_t
            line = f"fold_evals cubic_prod ({batch}, {n}) {mode}: " \
                   f"max_abs_err {err}"
            if err != 0:
                raise AssertionError(f"fold_evals cubic_prod differs from "
                                     f"its plain version at ({batch}, {n}) "
                                     f"{mode}")
            if (batch, n) == PROD_TIMED:
                ms = graph_ms(lambda: [rk.fold_evals(tabs, rr, mode)
                                       for _ in range(10)], 5) / 10
                eager = cuda_ms(lambda: rk.fold_evals(tabs, rr, mode), 10)
                bound = fold_evals_bound(3, n, mode, batch)
                line += (f", {ms:.4f} ms in a CUDA graph ({eager:.4f} ms "
                         f"launched one by one), bound "
                         f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}),"
                         f" plain {plain_ms:.1f} ms")
                result[mode] = dict(ms=ms, eager_ms=eager, plain_ms=plain_ms,
                                    max_abs_err=err, **bound)
            log(line)
        del tabs
    return result


def check_product_layer_chain(dev, shapes) -> dict:
    """B2's batched launches of a SNARK prove replayed on random tables:
    ``shapes`` counts the prove's own launches by (comb, batch, n, mode)
    (``fold_evals.launches``).  Timed in a CUDA graph and launched one by
    one, beside the summed bound."""
    import torch

    from spartan_tpu_torch.ff import round_kernel as rk

    shapes = sorted(shapes.items())
    most = max(b * n for (_, b, n, _), _ in shapes)
    g = torch.Generator(device=dev).manual_seed(3)
    bufs = [torch.randint(0, 1 << 28, (most, 8), generator=g, device=dev,
                          dtype=torch.int32) for _ in range(3)]

    def replay():
        for (_, b, n, mode), count in shapes:
            tabs = [t[:b * n].view(b, n, 8) for t in bufs]
            r = None if mode == "evals" else 1000003
            for _ in range(count):
                rk.fold_evals(tabs, r, mode)

    eager = cuda_ms(replay, 2)
    ms = graph_ms(replay, 3)
    launches = sum(c for _, c in shapes)
    bound = sum(c * fold_evals_bound(3, n, mode, b)["bound_ms"]
                for (_, b, n, mode), c in shapes)
    log(f"fold_evals cubic_prod per 2^{LOG_N} SNARK prove: {launches} "
        f"launches at {len(shapes)} shapes, replayed: {ms:.3f} ms in a "
        f"CUDA graph ({eager:.3f} ms launched one by one), bound "
        f"{bound:.3f} ms")
    return dict(launches_per_prove=launches, ms_per_prove=ms,
                eager_ms_per_prove=eager, bound_ms_per_prove=bound)


def row_msm_on(scalars_mont, gens_pc, what: str) -> dict:
    """B1 timed on a commitment's own table (``commit``'s row-MSM of
    ``from_mont`` of it), its bound counted on those scalars."""
    from spartan_tpu_torch.curve import row_msm as rm
    from spartan_tpu_torch.ff import fq
    from spartan_tpu_torch.poly import dense

    ell = scalars_mont.shape[0].bit_length() - 1
    left, right = dense.factored_lens(ell)
    s = fq.from_mont(scalars_mont).reshape(1 << left, 1 << right, 8)
    tab = gens_pc.gens.gens_n.msm_table(s.device)
    ms = cuda_ms(lambda: rm.row_msm(s, tab), 3)
    bound = row_msm_bound(s)
    log(f"row_msm {what} ({1 << left}, {1 << right}): {ms:.3f} ms, bound "
        f"{bound['bound_ms']:.3f} ms ({bound['bound_by']}; "
        f"{bound['full_digits_bound_ms']:.3f} ms counting the zero digits)")
    return dict(shape=[1 << left, 1 << right], ms=ms, **bound)


class RowMsmRows:
    """Keeps the first, middle and last rows of every ``msm_rows`` launch
    of B1 (scalars and result) while active, so that the main path's own
    launches can be held against the plain version afterwards."""

    def __enter__(self):
        from spartan_tpu_torch.curve import msm

        self.launches = []
        self._orig = msm.row_msm

        def keep(scalars, tab):
            out = self._orig(scalars, tab)
            L = scalars.shape[0]
            rows = sorted({0, L // 2, L - 1})
            self.launches.append((tuple(scalars.shape[:2]), tab,
                                  scalars[rows].clone(), out[rows].clone()))
            return out

        msm.row_msm = keep
        return self

    def __exit__(self, *exc):
        from spartan_tpu_torch.curve import msm

        msm.row_msm = self._orig

    def check(self, what: str, want_shapes) -> list:
        """Each kept launch's rows against the plain version on their
        scalars, compared as compressed points (the segment counts of
        the whole launch and of the rows differ, so the coordinates
        do)."""
        from spartan_tpu_torch.curve import edwards as ed
        from spartan_tpu_torch.curve import ristretto as dri
        from spartan_tpu_torch.curve import row_msm as rm

        shapes = [shape for shape, *_ in self.launches]
        missing = set(want_shapes) - set(shapes)
        if missing:
            raise AssertionError(f"row_msm in {what}: no launch at "
                                 f"{sorted(missing)} (launched {shapes})")
        for shape, tab, s, got in self.launches:
            want = rm.row_msm_plain(s, tab)
            if (dri.compress_to_bytes(ed.unstack(got))
                    != dri.compress_to_bytes(ed.unstack(want))):
                raise AssertionError(f"row_msm in {what} at {shape} "
                                     f"differs from its plain version")
        log(f"row_msm in {what}: first, middle and last rows of the "
            f"launches at {shapes} equal the plain version")
        return [list(shape) for shape in shapes]


def new_segments(mem0: dict) -> list[int]:
    """cudaMalloc calls of the caching allocator since the memory stats
    ``mem0``, and its retries (a retry frees the cache and synchronises)."""
    import torch

    mem = torch.cuda.memory_stats()
    return [mem.get(k, 0) - mem0.get(k, 0)
            for k in ("segment.all.allocated", "num_alloc_retries")]


def commit_profile(dev, gens) -> dict:
    """The 2^20 prove's witness commitment (``poly.commit.commit_canonical``,
    the ``polycommit`` phase's device part) once more on random witness
    values, under ``torch.profiler``: the wall of the call beside the
    device time of each kernel in it, so that the spans
    ``commit::msm_rows`` and ``commit::blinds`` can be read as kernel
    time and the rest."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from spartan_tpu_torch.poly import commit as pc

    gens_pc = gens.gens_r1cs_sat.gens_pc
    Z = rand_elems(torch.Generator().manual_seed(5), 1 << LOG_N, dev)
    mem0 = torch.cuda.memory_stats()
    pc.commit_canonical(Z, gens_pc, None)  # warm-up
    torch.cuda.synchronize()
    first_mallocs = new_segments(mem0)
    mem0 = torch.cuda.memory_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pc.commit_canonical(Z, gens_pc, None)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    mallocs = {"first_call": first_mallocs, "profiled": new_segments(mem0)}
    kernels = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            k = kernels.setdefault(e.name, [0, 0.0])
            k[0] += 1
            k[1] += e.time_range.elapsed_us() / 1e3
    busy = sum(v[1] for v in kernels.values())
    if busy <= 0:  # the profiler could not trace the card: no breakdown
        log(f"polycommit 2^{LOG_N} profiled: {wall_ms:.3f} ms wall, the "
            f"profiler recorded no device activity")
        return {"wall_ms": wall_ms, "device_ms": None,
                "device_mallocs": mallocs}
    log(f"polycommit 2^{LOG_N} profiled: {wall_ms:.3f} ms wall, "
        f"{busy:.3f} ms device time in {sum(v[0] for v in kernels.values())}"
        f" kernels; device allocations (cudaMalloc calls, retries): "
        f"{mallocs}")
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])
    for name, (n, ms) in top[:8]:
        log(f"  {ms:8.3f} ms  {n:5d} x  {name[:90]}")
    return {"wall_ms": wall_ms, "device_ms": busy, "device_mallocs": mallocs,
            "row_msm_kernels_ms": sum(ms for name, (n, ms) in kernels.items()
                                      if "msm_" in name)}


def golden(dev) -> None:
    from spartan_tpu_torch import serialize as ser
    from spartan_tpu_torch.api import NIZK, Instance, NIZKGens
    from spartan_tpu_torch.core.merlin import Transcript

    gdir = os.path.join(REPO, "tests", "golden")
    inst, vars_a, inputs_a = Instance.produce_synthetic_r1cs(
        16, 16, 2, seed=424242, device=dev)
    with open(os.path.join(gdir, "instance_digest.bin"), "rb") as f:
        if inst.digest != f.read():
            raise AssertionError("instance digest differs from the golden")
    gens = NIZKGens(16, 16, 2)
    nizk = NIZK.prove(inst, vars_a, inputs_a, gens,
                      Transcript(b"golden_nizk"), _tape_seed=31337)
    with open(os.path.join(gdir, "nizk_proof.bin"), "rb") as f:
        if ser.nizk_to_bytes(nizk) != f.read():
            raise AssertionError("NIZK bytes differ from the golden proof")
    nizk.verify(inst, inputs_a, Transcript(b"golden_nizk"), gens)
    log("golden: digest and NIZK bytes equal tests/golden, proof verifies")


def golden_snark(dev) -> None:
    from spartan_tpu_torch import serialize as ser
    from spartan_tpu_torch.api import SNARK, Instance, SNARKGens
    from spartan_tpu_torch.core.merlin import Transcript

    gdir = os.path.join(REPO, "tests", "golden")
    inst, vars_a, inputs_a = Instance.produce_synthetic_r1cs(
        16, 16, 2, seed=424242, device=dev)
    gens = SNARKGens(16, 16, 2, 16)
    comm, decomm = SNARK.encode(inst, gens)
    snark = SNARK.prove(inst, comm, decomm, vars_a, inputs_a, gens,
                        Transcript(b"golden_snark"), _tape_seed=31337)
    for name, blob in (("snark_commitment.bin",
                        ser.commitment_to_bytes(comm)),
                       ("snark_proof.bin", ser.snark_to_bytes(snark))):
        with open(os.path.join(gdir, name), "rb") as f:
            if blob != f.read():
                raise AssertionError(f"{name} differs from the golden")
    snark.verify(comm, inputs_a, Transcript(b"golden_snark"), gens)
    log("golden: SNARK commitment and proof bytes equal tests/golden, "
        "proof verifies")


# the NIZK's phase spans (utils/timer.py)
NIZK_SPANS = ["polycommit", "prove_sc_phase_one", "prove_sc_phase_two",
              "polyeval"]
# the Spark spans of a SNARK prove (utils/timer.py totals), in order
SNARK_SPANS = ["polycommit", "prove_sc_phase_one", "prove_sc_phase_two",
               "polyeval", "eval_sparse_polys", "R1CSEvalProof::prove",
               "commit_nondet_witness",
               "build_layered_network+evalproof_layered_network",
               "spark::hash_leaves", "spark::tree_build",
               "spark::dotp_evaluate", "spark::layer_rounds",
               "spark::evaluate", "polyeval::bound_L",
               "polyeval::dotproduct_log"]


def snark_main_path(dev, inst, vars_a, inputs_a) -> dict:
    """The SNARK through the public API on the NIZK's instance: gens,
    encode, prove, serialize, verify, a tampered copy rejected.  Counters
    reset just before encode and before prove, read just after each."""
    import torch

    from spartan_tpu_torch import serialize as ser
    from spartan_tpu_torch.api import SNARK, SNARKGens
    from spartan_tpu_torch.core.merlin import Transcript
    from spartan_tpu_torch.ff import round_kernel as rk
    from spartan_tpu_torch.poly import dense
    from spartan_tpu_torch.utils import rt, timer
    from spartan_tpu_torch.utils.errors import (ProofDeserializeError,
                                                ProofVerifyError)

    n, n_inputs = inst.inst.num_cons, inst.inst.num_inputs
    log_n = n.bit_length() - 1
    nnz = max(m.get_num_nz_entries()
              for m in (inst.inst.A, inst.inst.B, inst.inst.C))
    t0 = time.perf_counter()
    gens = SNARKGens(n, n, n_inputs, nnz)
    ev = gens.gens_r1cs_eval.gens
    for g in (gens.gens_r1cs_sat.gens_pc.gens.gens_n, ev.gens_ops.gens.gens_n,
              ev.gens_mem.gens.gens_n, ev.gens_derefs.gens.gens_n):
        g.msm_table(dev), g.msm_table_h(dev)
    torch.cuda.synchronize()
    gens_s = time.perf_counter() - t0
    log(f"snark 2^{log_n}: gens and tables built in {gens_s:.2f} s")

    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_stats()
    reset_counts()
    with RowMsmRows() as encode_rows:
        t0 = time.perf_counter()
        comm, decomm = SNARK.encode(inst, gens)
        torch.cuda.synchronize()
        encode_s = time.perf_counter() - t0
    encode_launches = read_counts()
    encode_peak = torch.cuda.max_memory_allocated()
    if encode_launches["row_msm"] <= 0:
        raise AssertionError(f"row_msm never launched in encode: "
                             f"{encode_launches}")

    torch.cuda.reset_peak_memory_stats()
    mem1 = torch.cuda.memory_stats()
    prove_start_bytes = torch.cuda.memory_allocated()
    timer.totals.clear()
    f0, s0 = rt.snapshot()
    reset_counts()
    with RowMsmRows() as prove_rows:
        t0 = time.perf_counter()
        snark = SNARK.prove(inst, comm, decomm, vars_a, inputs_a, gens,
                            Transcript(b"chip_smoke_snark"), _tape_seed=7)
        torch.cuda.synchronize()
        prove_s = time.perf_counter() - t0
    prove_launches = read_counts()
    prod_shapes = collections.Counter(
        {k: c for k, c in rk.fold_evals.launches.items()
         if k[0] == "cubic_prod"})
    f1, s1 = rt.snapshot()
    prove_peak = torch.cuda.max_memory_allocated()
    spans = {k: timer.totals.get(k) for k in SNARK_SPANS}
    if min(prove_launches["row_msm"],
           prove_launches["fold_evals_by_comb"]["cubic_prod"],
           prove_launches["point_msm"], prove_launches["bullet_step"],
           prove_launches["ristretto_compress"]) <= 0:
        raise AssertionError(f"a kernel never launched in prove: "
                             f"{prove_launches}")

    def dims(table):
        left, right = dense.factored_lens(table.shape[0].bit_length() - 1)
        return 1 << left, 1 << right

    dense_rep = decomm.decomm.dense
    checked = {
        "encode": encode_rows.check("encode", [dims(dense_rep.comb_ops),
                                               dims(dense_rep.comb_mem)]),
        # the derefs table is half the ops table
        "prove": prove_rows.check("prove", [dims(dense_rep.comb_ops[
            :dense_rep.comb_ops.shape[0] // 2])])}

    blob = ser.snark_to_bytes(snark)
    comm_blob = ser.commitment_to_bytes(comm)
    t0 = time.perf_counter()
    ser.snark_from_bytes(blob).verify(ser.commitment_from_bytes(comm_blob),
                                      inputs_a,
                                      Transcript(b"chip_smoke_snark"), gens)
    verify_s = time.perf_counter() - t0
    verify_spans = {k: timer.records[k]
                    for k in ("verify_sat_proof", "verify_eval_proof")}
    rejected = []
    for off in (len(blob) // 2, len(blob) - 100):
        bad = bytearray(blob)
        bad[off] ^= 1
        try:
            ser.snark_from_bytes(bytes(bad)).verify(
                ser.commitment_from_bytes(comm_blob), inputs_a,
                Transcript(b"chip_smoke_snark"), gens)
        except (ProofVerifyError, ProofDeserializeError) as e:
            rejected.append(off)
            log(f"tampered SNARK (byte {off}) rejected: "
                f"{type(e).__name__}: {e}")
        else:
            raise AssertionError(f"a tampered SNARK (byte {off}) verified")

    spark_msm = [
        row_msm_on(decomm.decomm.dense.comb_ops, ev.gens_ops, "comb_ops"),
        row_msm_on(decomm.decomm.dense.comb_mem, ev.gens_mem, "comb_mem"),
        row_msm_on(rand_elems(torch.Generator().manual_seed(9),
                              decomm.decomm.dense.comb_ops.shape[0] // 2,
                              dev), ev.gens_derefs,
                   "derefs (random eq values)")]
    summary = {"log_n": log_n, "num_inputs": n_inputs, "nnz": nnz,
               "gens_s": gens_s, "encode_s": encode_s, "prove_s": prove_s,
               "verify_s": verify_s, "spans_s": spans,
               "verify_spans_s": verify_spans,
               "prove_fetches": f1 - f0, "prove_fetch_stall_s": s1 - s0,
               "peak_device_bytes": {"encode": encode_peak,
                                     "prove": prove_peak},
               "device_bytes_at_prove_start": prove_start_bytes,
               "device_mallocs_prove": new_segments(mem1),
               "device_mallocs_encode_and_prove": new_segments(mem0),
               "commitment_bytes": len(comm_blob), "proof_bytes": len(blob),
               "launches": {"encode": encode_launches,
                            "prove": prove_launches},
               "tampered_rejected_at": rejected,
               "row_msm_rows_checked_at": checked,
               "row_msm_on_spark_tables": spark_msm}
    log("snark " + json.dumps(summary))
    return summary, prod_shapes, dict(gens=gens, comm=comm, decomm=decomm,
                                      blob=blob)


def make_instance(dev, log_n: int):
    """The flagship instance, 2^log_n constraints and variables with 10
    inputs, from seed 1: (instance, vars, inputs, seconds)."""
    import torch

    from spartan_tpu_torch.api import Instance

    t0 = time.perf_counter()
    n = 1 << log_n
    inst, vars_a, inputs_a = Instance.produce_synthetic_r1cs(
        n, n, 10, seed=1, device=dev)
    torch.cuda.synchronize()
    return inst, vars_a, inputs_a, time.perf_counter() - t0


def _plains():
    from spartan_tpu_torch.curve import point_msm as pm
    from spartan_tpu_torch.curve import ristretto as dri
    from spartan_tpu_torch.curve import row_msm as rm
    from spartan_tpu_torch.ff import bullet_kernel as bk
    from spartan_tpu_torch.ff import round_kernel as rk
    from spartan_tpu_torch.transcript import device as dt

    return (rm.row_msm_plain, rk.fold_evals_plain, dt.strobe_step_plain,
            dri.compress_plain, pm.point_msm_plain, bk.bullet_step_plain)


def reset_counts() -> None:
    from spartan_tpu_torch.curve import point_msm as pm
    from spartan_tpu_torch.curve import ristretto as dri
    from spartan_tpu_torch.curve import row_msm as rm
    from spartan_tpu_torch.ff import bullet_kernel as bk
    from spartan_tpu_torch.ff import fq
    from spartan_tpu_torch.ff import round_kernel as rk
    from spartan_tpu_torch.transcript import device as dt

    rm.row_msm.launches = pm.point_msm.launches = fq.to_mont.launches = 0
    rk.fold_evals.launches.clear()
    rk.fold_evals.launches_device_r = 0
    bk.bullet_step.launches.clear()
    dt.strobe_step.launches = dri.compress.launches = 0
    for f in _plains():
        f.cuda_calls = 0


def read_counts() -> dict:
    """The launch counts since reset_counts(); raises on a plain-version
    call on the card (every plain version's ``cuda_calls`` is printed)."""
    from spartan_tpu_torch.curve import point_msm as pm
    from spartan_tpu_torch.curve import ristretto as dri
    from spartan_tpu_torch.curve import row_msm as rm
    from spartan_tpu_torch.ff import bullet_kernel as bk
    from spartan_tpu_torch.ff import fq
    from spartan_tpu_torch.ff import round_kernel as rk
    from spartan_tpu_torch.transcript import device as dt

    calls = {f.__name__: f.cuda_calls for f in _plains()}
    plain = sum(calls.values())
    if plain:
        raise AssertionError(f"plain-version calls on the card: {calls}")
    by_comb = dict.fromkeys(rk._WHICH.values(), 0)
    for (comb, *_), count in rk.fold_evals.launches.items():
        by_comb[comb] += count
    return {"row_msm": rm.row_msm.launches,
            "fold_evals": sum(by_comb.values()),
            "fold_evals_by_comb": by_comb,
            "fold_evals_device_r": rk.fold_evals.launches_device_r,
            "strobe_step": dt.strobe_step.launches,
            "ristretto_compress": dri.compress.launches,
            "point_msm": pm.point_msm.launches,
            "bullet_step": sum(bk.bullet_step.launches.values()),
            "bullet_step_by_mode": dict(bk.bullet_step.launches),
            "to_mont": fq.to_mont.launches,
            "plain_calls_on_card": plain, "plain_cuda_calls": calls}


def nizk_main_path(dev, inst, vars_a, inputs_a, setup_s: float) -> dict:
    """The main path through the public API, counters reset just before
    the prove and read just after it."""
    import torch

    from spartan_tpu_torch import serialize as ser
    from spartan_tpu_torch.api import NIZK, NIZKGens
    from spartan_tpu_torch.core.merlin import Transcript
    from spartan_tpu_torch.utils import timer
    from spartan_tpu_torch.utils.errors import (ProofDeserializeError,
                                                ProofVerifyError)

    n, n_inputs = inst.inst.num_cons, inst.inst.num_inputs
    log_n = n.bit_length() - 1
    t0 = time.perf_counter()
    gens = NIZKGens(n, n, n_inputs)
    gens_pc = gens.gens_r1cs_sat.gens_pc.gens.gens_n
    gens_pc.msm_table(dev), gens_pc.msm_table_h(dev)
    torch.cuda.synchronize()
    setup_s += time.perf_counter() - t0
    log(f"nizk 2^{log_n}: instance and gens built in {setup_s:.2f} s")

    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_stats()
    start_bytes = torch.cuda.memory_allocated()
    reset_counts()
    t0 = time.perf_counter()
    nizk = NIZK.prove(inst, vars_a, inputs_a, gens,
                      Transcript(b"chip_smoke"), _tape_seed=7)
    torch.cuda.synchronize()
    prove_s = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    mallocs = new_segments(mem0)
    phases = {k: timer.records[k] for k in NIZK_SPANS}
    if min(launches["row_msm"], launches["fold_evals"],
           launches["point_msm"], launches["bullet_step"],
           launches["ristretto_compress"], launches["to_mont"]) <= 0:
        raise AssertionError(f"a kernel never launched: {launches}")

    blob = ser.nizk_to_bytes(nizk)
    t0 = time.perf_counter()
    ser.nizk_from_bytes(blob).verify(inst, inputs_a,
                                     Transcript(b"chip_smoke"), gens)
    verify_s = time.perf_counter() - t0
    bad = bytearray(blob)
    bad[len(bad) // 2] ^= 1
    try:
        ser.nizk_from_bytes(bytes(bad)).verify(
            inst, inputs_a, Transcript(b"chip_smoke"), gens)
    except (ProofVerifyError, ProofDeserializeError) as e:
        log(f"tampered proof rejected: {type(e).__name__}: {e}")
    else:
        raise AssertionError("a tampered proof verified")
    summary = {"log_n": log_n, "num_inputs": n_inputs, "setup_s": setup_s,
               "prove_s": prove_s, "verify_s": verify_s, "phases_s": phases,
               "peak_device_bytes": peak,
               "device_bytes_at_start": start_bytes, "device_mallocs": mallocs,
               "proof_bytes": len(blob),
               "launches": launches}
    summary["polycommit_profile"] = commit_profile(dev, gens)
    log("nizk " + json.dumps(summary))
    return summary, dict(gens=gens, blob=blob)


# The device prover's own kernels (protocols/device_prover.py): K3, one
# STROBE step of the device transcript (csrc/keccak.cu), and K4, the
# ristretto encode (csrc/ristretto.cu).  K3's bound is the latency of the
# permutation's dependent chain: 7 dependent 32-bit ALU steps a round on
# sm_90 (theta's five-input column parity as 2 three-input LOP3s, its
# 1-bit rotate as two independent funnel shifts, 1, and the D xor fused
# with the lane xor in one LOP3, 1; rho's rotate 1; chi's a ^ (~b & c)
# one LOP3, 1; iota 1) at ~4 cycles each, 24 rounds, at the boost
# clock; the absorb's xors before the permutation are left out, so it
# stays a lower bound.  K4's is its field products (the inverse
# square root's 251 squarings and 11 products, 22 around them, 72 wide
# multiply-adds each) over the card's IMAD rate.
K3_STATES = 1024
K4_POINTS = 4096
# K4 also on the last 1, 3 and 33 of its points: a partial group of lanes,
# a partial block (16 points a block of 128 threads) and more than two
# blocks
K4_SIZES = [1, 3, 33]
KECCAK_CHAIN_PER_ROUND = 7
ALU_LATENCY_CYCLES = 4
CLOCK_HZ = 1.98e9
ENCODE_FP_MULS = 284
ENCODE_SQUARINGS = 251
# B2 with a device challenge: the NIZK's phase tables and the product
# layers' largest batch
DEVICE_R_CASES = [(4, (1 << 20,)), (2, (1 << 21,)), (3, (18, 1 << 19))]


def strobe_step_bound() -> dict:
    t_ops = 24 * KECCAK_CHAIN_PER_ROUND * ALU_LATENCY_CYCLES / CLOCK_HZ * 1e3
    t_bytes = 3 * 200 / HBM_BYTES_S * 1e3  # state in and out, the mask
    return dict(bound_ms=max(t_ops, t_bytes),
                bound_by="bytes" if t_bytes > t_ops else "operations")


def compress_bound(k: int) -> dict:
    t_bytes = k * (128 + 32) / HBM_BYTES_S * 1e3
    t_ops = (k * ENCODE_FP_MULS * FP_MUL_WIDE * IMAD_PER_WIDE / IMAD_S
             * 1e3)
    return dict(bound_ms=max(t_ops, t_bytes),
                bound_by="bytes" if t_bytes > t_ops else "operations")


# K3's segment sets, as (offset, length): three segments, 16 adjacent
# ones (the most a step takes) ending at byte 199, and segments at odd
# offsets, adjacent and apart, the last ending at byte 199
K3_SEG_SETS = {
    "three": [(8, 32), (60, 64), (193, 7)],
    "sixteen": [(64 + sum(range(1, n)), n) for n in range(1, 17)],
    "odd": [(1, 6), (7, 24), (31, 2), (35, 100), (135, 65)],
}


def check_strobe_step(dev, gen, floor: dict) -> dict:
    """K3 against its plain version on K3_STATES random states for each
    segment set of K3_SEG_SETS: a mask, the segments and the permutation;
    for the first set also without a mask, and without the permutation;
    timed in a CUDA graph and launched one by one, beside the launch
    floor of an empty kernel."""
    import torch

    from spartan_tpu_torch.transcript import device as dt

    def rbytes(n):
        return torch.randint(0, 256, (n,), generator=gen,
                             dtype=torch.int64).to(torch.uint8)

    states = torch.stack([rbytes(200) for _ in range(K3_STATES)]).to(dev)
    mask = bytes(rbytes(200).tolist())
    err, forms = 0, []
    for name, spans in K3_SEG_SETS.items():
        segs = [(rbytes(n).to(dev), off) for off, n in spans]
        cases = ((mask, True), (None, True), (mask, False)) \
            if name == "three" else ((mask, True), (None, False))
        for m, permute in cases:
            want = states.clone()
            dt.strobe_step_plain(want, m, segs, permute)
            got = states.clone()
            for i in range(K3_STATES):
                dt.strobe_step(got[i], m, segs, permute)
            torch.cuda.synchronize()
            err = max(err, max_abs_err(got.int(), want.int()))
            forms.append(f"{name}/{'mask' if m else 'no mask'}/"
                         f"{'permute' if permute else 'absorb'}")
        if name == "three":
            timed = segs
    one = states[0].clone()
    t0 = time.perf_counter()
    dt.strobe_step_plain(one, mask, timed, True)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    ms = graph_ms(lambda: [dt.strobe_step(one, mask, timed, True)
                           for _ in range(100)], 5) / 100
    eager = cuda_ms(lambda: dt.strobe_step(one, mask, timed, True), 100)
    bound = strobe_step_bound()
    log(f"strobe_step (K3) on {K3_STATES} states x {len(forms)} forms "
        f"({', '.join(forms)}): max_abs_err {err}; {ms * 1e3:.3f} us in a "
        f"CUDA graph ({eager * 1e3:.3f} us launched one by one), bound "
        f"{bound['bound_ms'] * 1e3:.3f} us ({bound['bound_by']}); an empty "
        f"kernel {floor['graph_ms'] * 1e3:.3f} us in a graph, "
        f"{floor['eager_ms'] * 1e3:.3f} us one by one; plain "
        f"{plain_ms:.1f} ms")
    if err:
        raise AssertionError("strobe_step differs from its plain version")
    return dict(shape=[200], max_abs_err=err, ms=ms, eager_ms=eager,
                plain_ms=plain_ms, forms=forms, launch_floor_ms=floor,
                **bound)


def encode_branch(pt) -> tuple[bool, bool]:
    """(rotate, y negated) of ENCODE at this representative (RFC 9496
    section 4.3.2), on the host."""
    from spartan_tpu_torch.core import field as F
    from spartan_tpu_torch.core.field import P25519 as P

    X, Y, Z, T = pt.X, pt.Y, pt.Z, pt.T
    u1 = (Z + Y) * (Z - Y) % P
    _, inv = F.sqrt_ratio_m1(1, u1 * (X * Y) ** 2 % P)
    z_inv = inv * u1 % P * (inv * X * Y % P) % P * T % P
    rotate = F.is_negative(T * z_inv % P)
    x = Y * F.SQRT_M1 % P if rotate else X
    return rotate, F.is_negative(x * z_inv % P)


def check_compress(dev, gen, lat: dict, floor: dict) -> dict:
    """K4 against its plain version on K4_POINTS random points (s * B,
    made by B1), the identity, and points of every branch, and on the
    last K4_SIZES of them (partial groups and blocks, the identity
    last); timed at the ZK
    rounds' two points and at K4_POINTS + 1, beside its bound, its chain
    floor at the group's product and squaring latencies ``lat`` and at
    the one-lane product's, and the launch floor ``floor``."""
    import torch

    from spartan_tpu_torch.commitments import build_table
    from spartan_tpu_torch.core import edwards as hed
    from spartan_tpu_torch.curve import edwards as ed
    from spartan_tpu_torch.curve import ristretto as dri
    from spartan_tpu_torch.curve import row_msm as rm

    s = rand_elems(gen, K4_POINTS, dev).reshape(K4_POINTS, 1, 8)
    pts = torch.cat([rm.row_msm(s, build_table([hed.BASEPOINT], dev)),
                     ed.stack(ed.identity((1,), dev))])
    branches = {encode_branch(p) for p in ed.to_host(ed.unstack(pts[:64]))}
    if len(branches) < 4:
        raise AssertionError(f"the check's points miss a branch of ENCODE: "
                             f"{branches}")
    p = ed.unstack(pts)
    t0 = time.perf_counter()
    want = dri.compress_plain(p)
    torch.cuda.synchronize()
    plain_all_ms = (time.perf_counter() - t0) * 1e3
    got = dri.compress(p)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    for n in K4_SIZES:
        got_n = dri.compress(ed.unstack(pts[-n:]))
        torch.cuda.synchronize()
        err = max(err, max_abs_err(got_n, want[-n:]))
    p2 = ed.unstack(pts[:2])
    t0 = time.perf_counter()
    dri.compress_plain(p2)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    ms = graph_ms(lambda: [dri.compress(p2) for _ in range(20)], 5) / 20
    ms_all = graph_ms(lambda: dri.compress(p), 5)
    bound = compress_bound(2)
    bound_all = compress_bound(K4_POINTS + 1)
    chain = (ENCODE_SQUARINGS * lat["group_sqr_ns"]
             + (ENCODE_FP_MULS - ENCODE_SQUARINGS) * lat["group_mul_ns"])
    chain_ms = chain * 1e-6
    one_lane_ms = ENCODE_FP_MULS * lat["fp_mul_one_lane_ns"] * 1e-6
    log(f"ristretto_compress (K4) on {K4_POINTS + 1} points (branches "
        f"{sorted(branches)}) and on the last {K4_SIZES} of them: "
        f"max_abs_err {err}; 2 points {ms:.4f} ms in a CUDA graph, bound "
        f"{bound['bound_ms']:.6f} ms ({bound['bound_by']}), chain floor "
        f"{chain_ms:.4f} ms ({ENCODE_SQUARINGS} squarings x "
        f"{lat['group_sqr_ns']:.1f} ns + "
        f"{ENCODE_FP_MULS - ENCODE_SQUARINGS} products x "
        f"{lat['group_mul_ns']:.1f} ns on a group of 8 lanes; "
        f"{one_lane_ms:.4f} ms at the one-lane product's "
        f"{lat['fp_mul_one_lane_ns']:.1f} ns), an empty kernel "
        f"{floor['graph_ms']:.4f} ms in a graph ({floor['eager_ms']:.4f} "
        f"ms one by one), plain {plain_ms:.1f} ms; "
        f"{K4_POINTS + 1} points {ms_all:.4f} ms, bound "
        f"{bound_all['bound_ms']:.4f} ms ({bound_all['bound_by']}), plain "
        f"{plain_all_ms:.1f} ms")
    if err:
        raise AssertionError("compress differs from its plain version")
    return dict(shape=[2], max_abs_err=err, ms=ms, plain_ms=plain_ms,
                **bound, chain_floor_ms=chain_ms,
                chain_floor_one_lane_ms=one_lane_ms, product_latency_ns=lat,
                launch_floor_ms=floor, ms_4097=ms_all,
                plain_ms_4097=plain_all_ms,
                bound_ms_4097=bound_all["bound_ms"])


def check_fold_evals_device_r(dev, gen) -> dict:
    """B2 with its challenge read through a pointer against the by-value
    form at DEVICE_R_CASES, both r-taking modes; the two forms timed
    side by side at (4, 2^20) fold+evals in a CUDA graph."""
    import torch

    from spartan_tpu_torch.core.field import Q
    from spartan_tpu_torch.ff import fq
    from spartan_tpu_torch.ff import round_kernel as rk

    r = (11 ** 101) % Q
    r_dev = fq.mont_limbs(r, dev)
    result = {}
    for ntab, shape in DEVICE_R_CASES:
        n = 1
        for d in shape:
            n *= d
        tabs = [rand_elems(gen, n, dev).reshape(*shape, 8)
                for _ in range(ntab)]
        for mode in ("fold_evals", "fold"):
            got_t, got_e = rk.fold_evals(tabs, r_dev, mode)
            want_t, want_e = rk.fold_evals(tabs, r, mode)
            torch.cuda.synchronize()
            err = max(max_abs_err(a, b) for a, b in zip(got_t, want_t))
            if mode != "fold":
                err = max(err, max_abs_err(got_e, want_e))
            log(f"fold_evals device r, ntab {ntab} {shape} {mode}: "
                f"max_abs_err {err} against the by-value form")
            if err:
                raise AssertionError(f"fold_evals with a device r differs "
                                     f"at {ntab} {shape} {mode}")
            del got_t, want_t
        if (ntab, shape) == DEVICE_R_CASES[0]:
            for name, rr in (("by_value", r), ("device", r_dev),
                             ("device_again", r_dev),
                             ("by_value_again", r)):
                result[f"{name}_ms"] = graph_ms(
                    lambda: [rk.fold_evals(tabs, rr, "fold_evals")
                             for _ in range(10)], 5) / 10
            log(f"fold_evals (4, 2^20) fold+evals, r by value / device / "
                f"device / by value: " + ", ".join(
                    f"{v:.4f}" for v in result.values()) + " ms")
        del tabs
    return result


# K5, the grouped variable-base MSM (csrc/point_msm.cu), and K6, the bullet
# round's scalar step (csrc/bullet_step.cu): the bullet rounds' and the
# device dot-product-log's kernels, and the device ZK rounds' commitments.
# K5 at the path's shapes: the first bullet round's cross terms at n =
# 2,048 (two groups of 1,026, L and R) and n = 4,096 (two
# of 2,050) of Spark's dot-product-log proofs, Cx at n = 4,096 (one group
# of 4,097), G folds of 1,024 and 2,048 pairs, a ZK round's 5 groups of
# 7, and small groups of 11 points (no multiple of a quad's 4 lanes) with
# the edge scalars.  Its bound counts its field products: a point's table
# (7 cached additions of 8 products, 8 conversions of 4), 63 x 4
# doublings (8) and 64 cached additions (8), and N - G unified additions
# (9) for the groups.  Its chain floor is the longest dependent chain of
# a launch in products times one product's latency (measured on the card
# by a one-thread chain of fp_mul): a point's 654 product-steps (a quad
# runs a point operation as two steps of one product a lane: 7 table
# additions, 8 conversions of one step, 64 additions and 252 doublings),
# then its group's additions on one lane and the halving tree, 3
# dependent products each (the unified addition's depth).
K5_CASES = [("cross_2048", (1026, 1026)), ("cross_4096", (2050, 2050)),
            ("cx_4096", (4097,)), ("fold_1024", (2,) * 1024),
            ("fold_2048", (2,) * 2048), ("zk_round", (7,) * 5),
            ("edges", (3, 1, 0, 5, 2))]
K5_POINT_FP_MULS = 7 * 8 + 8 * 4 + 252 * 8 + 64 * 8
K5_POINT_CHAIN = 7 * 2 + 8 + 64 * 2 + 252 * 2
K5_GROUP_ADD_CHAIN = 3
# The earlier design's times a launch (one thread a point for K5, u^-1 by
# Fermat for K6's fold, at any n): commit df4a02a's chip_smoke.py on an
# "NVIDIA H100 80GB HBM3, 700.00 W".  Printed in the log lines beside this
# run's times, for comparison; never in the kernels line, which holds
# only this run's measurements.
K5_EARLIER_MS = {"cross_2048": 1.143, "cross_4096": 1.190, "cx_4096": 1.283,
                 "fold_1024": 1.076, "fold_2048": 1.089, "zk_round": 0.969}
K6_EARLIER_FOLD_MS = 0.1404
K6_SIZES = [1024, 2048, 4096]
# A constant-time safegcd inverse of an input below 2^256 runs 590
# divsteps, each on the low word of the last one's f and g: the least
# dependent chain an inverse by safegcd needs, whatever its limbs.  The
# fold's bound counts them at the latency of the shortest divstep this
# card runs, measured by a one-thread chain (divstep_latency_ns); the
# matrix updates between batches, which more threads could share, are
# left out.
SAFEGCD_DIVSTEPS = 590
# bullet rounds compared on the host and on the device (n = 2^1 ... 2^12)
ROUND_LOGS = range(1, 13)


def point_msm_bound(sizes, lanes: int, product_ns: float) -> dict:
    """The operations bound and the chain floor (one product's latency
    ``product_ns``) of a launch at ``sizes`` summed in ``lanes`` lanes."""
    n, groups = sum(sizes), len(sizes)
    products = n * K5_POINT_FP_MULS + (n - groups) * 9
    t_ops = products * FP_MUL_WIDE * IMAD_PER_WIDE / IMAD_S * 1e3
    t_bytes = (n * (128 + 32) + groups * (128 + 4)) / HBM_BYTES_S * 1e3
    group_adds = -(-max(sizes) // lanes) - 1 + (lanes.bit_length() - 1)
    chain = K5_POINT_CHAIN + group_adds * K5_GROUP_ADD_CHAIN
    return dict(bound_ms=max(t_ops, t_bytes),
                bound_by="bytes" if t_bytes > t_ops else "operations",
                chain_steps=chain, chain_floor_ms=chain * product_ns * 1e-6)


def product_latency_ns(dev) -> float:
    """One field product's latency mod p on the card: a one-thread chain
    of fp_mul (csrc/point_msm.cu's fp_mul_chain_kernel) of 2^15 products
    less one of 0, over 2^15; medians of 5."""
    import statistics

    import torch

    from spartan_tpu_torch import _build
    from spartan_tpu_torch.curve import point_msm as pm

    lib = _build.load("point_msm", pm._declare)
    xy = rand_elems(torch.Generator().manual_seed(3), 2, dev)
    steps = 1 << 15

    def run(k):
        rc = lib.fp_mul_chain_launch(xy.data_ptr(), k,
                                     _build.stream_handle(dev))
        _build.check(rc, "fp_mul_chain")

    per = [(cuda_ms(lambda: run(steps), 3) - cuda_ms(lambda: run(0), 3))
           / steps * 1e6 for _ in range(5)]
    return statistics.median(per)


def group_latency_ns(dev, square: int) -> float:
    """One product's (``square``: squaring's) latency mod p on a group of
    8 lanes (csrc/ristretto.cu's g_mul_chain_kernel): a chain of 2^14
    less one of 0, over 2^14; medians of 5."""
    import statistics

    import torch

    from spartan_tpu_torch import _build
    from spartan_tpu_torch.curve import ristretto as dri

    lib = _build.load("ristretto", dri._declare)
    xy = rand_elems(torch.Generator().manual_seed(3), 2, dev)
    steps = 1 << 14

    def run(k):
        rc = lib.g_mul_chain_launch(xy.data_ptr(), k, square,
                                    _build.stream_handle(dev))
        _build.check(rc, "g_mul_chain")

    per = [(cuda_ms(lambda: run(steps), 3) - cuda_ms(lambda: run(0), 3))
           / steps * 1e6 for _ in range(5)]
    return statistics.median(per)


def launch_floor_ms(dev) -> dict:
    """An empty kernel's time a launch, in a CUDA graph of 100 and
    launched one by one (csrc/ristretto.cu's empty_kernel)."""
    from spartan_tpu_torch import _build
    from spartan_tpu_torch.curve import ristretto as dri

    lib = _build.load("ristretto", dri._declare)

    def run():
        _build.check(lib.empty_launch(_build.stream_handle(dev)), "empty")

    return dict(graph_ms=graph_ms(lambda: [run() for _ in range(100)], 5)
                / 100, eager_ms=cuda_ms(run, 100))


def encode_latencies(dev) -> dict:
    """K4's product and squaring latencies on a group of 8 lanes beside
    the one-lane fp_mul's (csrc/point_msm.cu)."""
    lat = {"fp_mul_one_lane_ns": product_latency_ns(dev),
           "group_mul_ns": group_latency_ns(dev, 0),
           "group_sqr_ns": group_latency_ns(dev, 1)}
    log(f"fp latency: one-lane fp_mul {lat['fp_mul_one_lane_ns']:.1f} ns; "
        f"a group of 8 lanes: product {lat['group_mul_ns']:.1f} ns, "
        f"squaring {lat['group_sqr_ns']:.1f} ns")
    return lat


def divstep_latency_ns(dev, wide: int) -> float:
    """One divstep's latency on the card: a one-thread chain of divstep
    batches (csrc/bullet_step.cu's divstep_chain_kernel: 30 divsteps a
    batch on 32-bit words for wide = 0, the fold's 59 on 64-bit words for
    wide = 1) of about 2^15 divsteps, less one of none, over its
    divsteps; medians of 5."""
    import statistics

    import torch

    from spartan_tpu_torch import _build
    from spartan_tpu_torch.ff import bullet_kernel as bk

    lib = _build.load("bullet_step", bk._declare)
    fgz = torch.tensor([0x1812631a5cf5d3ed, 0x0123456789abcdef, -1],
                       dtype=torch.int64, device=dev)
    per_batch = 59 if wide else 30
    batches = (1 << 15) // per_batch

    def run(k):
        rc = lib.divstep_chain_launch(fgz.data_ptr(), k, wide,
                                      _build.stream_handle(dev))
        _build.check(rc, "divstep_chain")

    per = [(cuda_ms(lambda: run(batches), 3) - cuda_ms(lambda: run(0), 3))
           / (batches * per_batch) * 1e6 for _ in range(5)]
    return statistics.median(per)


def bullet_step_bound(mode: str, n: int, divstep_ns: float) -> dict:
    """The larger of bytes (each input read once, each output written
    once) and, for fold, the inverse's chain: SAFEGCD_DIVSTEPS divsteps
    one after another at ``divstep_ns`` each."""
    m = n // 2
    bytes_ = {"cross": 2 * n * 32 + 64 + 2 * (m + 2) * 32,
              "fold": 2 * n * 32 + 64 + 64 + n * 32 + m * 64}[mode]
    t_bytes = bytes_ / HBM_BYTES_S * 1e3
    t_ops = SAFEGCD_DIVSTEPS * divstep_ns * 1e-6 if mode == "fold" else 0.0
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="operations" if t_ops > t_bytes else "bytes")


def random_points(gen, n: int, dev):
    """(n, 4, 8) points s * B for random s (made by B1), the identity
    first."""
    import torch

    from spartan_tpu_torch.commitments import build_table
    from spartan_tpu_torch.core import edwards as hed
    from spartan_tpu_torch.curve import edwards as ed
    from spartan_tpu_torch.curve import row_msm as rm

    s = rand_elems(gen, n, dev).reshape(n, 1, 8)
    pts = rm.row_msm(s, build_table([hed.BASEPOINT], dev))
    pts[0] = ed.stack(ed.identity((), dev))
    return pts.contiguous()


def check_point_msm(dev, gen) -> dict:
    """K5 against its plain version, bit for bit, at K5_CASES (the
    scalars 0, 1, q - 1, 2^252 and one whose signed radix-16 digits below
    the top are all -8, and the identity point, first); each case
    timed launched one by one and in a CUDA graph, beside its bound, its
    chain floor and the one-thread design's time."""
    import torch

    from spartan_tpu_torch.core.field import Q
    from spartan_tpu_torch.curve import point_msm as pm

    product_ns = product_latency_ns(dev)
    log(f"fp_mul latency (one-thread chain of 2^15 products): "
        f"{product_ns:.2f} ns a product")
    edges = [0, 1, Q - 1, 1 << 252, (7 * 16 ** 63 + 8) // 15]
    result = {"product_ns": product_ns}
    for name, sizes in K5_CASES:
        offs = [0]
        for k in sizes:
            offs.append(offs[-1] + k)
        n = offs[-1]
        pts = random_points(gen, n, dev)
        s = with_edges(rand_elems(gen, n, dev), edges)
        t0 = time.perf_counter()
        want = pm.point_msm_plain(pts, s, offs)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        got = pm.point_msm(pts, s, offs)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        if err:
            raise AssertionError(f"point_msm differs from its plain version "
                                 f"at {name}")
        ms = cuda_ms(lambda: pm.point_msm(pts, s, offs), 5)
        graph = graph_ms(lambda: pm.point_msm(pts, s, offs), 5)
        bound = point_msm_bound(sizes, pm.lanes(offs), product_ns)
        earlier = K5_EARLIER_MS.get(name)
        log(f"point_msm (K5) {name} ({n} points, {len(sizes)} groups, "
            f"{pm.lanes(offs)} lanes): max_abs_err {err}; {ms:.4f} ms "
            f"launched one by one, {graph:.4f} ms in a CUDA graph, bound "
            f"{bound['bound_ms']:.5f} ms ({bound['bound_by']}), chain floor "
            f"{bound['chain_floor_ms']:.4f} ms ({bound['chain_steps']} "
            f"product-steps), plain {plain_ms:.1f} ms"
            + (f"; one thread a point: {earlier} ms" if earlier else ""))
        result[name] = dict(points=n, groups=len(sizes), ms=ms,
                            graph_ms=graph, plain_ms=plain_ms,
                            max_abs_err=err, **bound)
    return result


def check_bullet_step(dev, gen) -> dict:
    """K6 against its plain version in every mode (fold with u as
    Montgomery words and as challenge bytes, and at u = 1, q - 1 and
    2^200) at K6_SIZES; cross and fold timed in a CUDA graph, beside their
    bounds (the fold's from one divstep's latency, measured here) and the
    fold beside the Fermat fold's time."""
    import torch

    from spartan_tpu_torch.core.field import Q
    from spartan_tpu_torch.ff import fq
    from spartan_tpu_torch.ff.bullet_kernel import (bullet_step,
                                                    bullet_step_plain)

    divstep_ns = {w: divstep_latency_ns(dev, wide)
                  for w, wide in (("32", 0), ("64", 1))}
    log(f"divstep latency (one-thread chains of ~2^15 divsteps): "
        f"{divstep_ns['32']:.3f} ns on 32-bit words, {divstep_ns['64']:.3f} "
        f"ns on the fold's 64-bit words; the fold's bound counts "
        f"{SAFEGCD_DIVSTEPS} of the shorter")
    floor_ns = min(divstep_ns.values())
    result = {"divstep_ns_32": divstep_ns["32"],
              "divstep_ns_64": divstep_ns["64"]}
    chal = torch.randint(0, 256, (64,), generator=gen,
                         dtype=torch.int64).to(torch.uint8).to(dev)
    edge_u = fq.encode_ints([1, Q - 1, 1 << 200], dev)
    err = 0
    for n in K6_SIZES:
        a, b = rand_elems(gen, n, dev), rand_elems(gen, n, dev)
        x = rand_elems(gen, 4, dev)  # blinds, u, blind_fin
        for mode, u in (("cross", None), ("fold", x[2]), ("fold", chal),
                        *(("fold", e) for e in edge_u)):
            if mode == "cross":
                args = (a, b, x[:2])
                got, want = [bullet_step(mode, *args)], [
                    bullet_step_plain(mode, *args)]
            else:
                bk, bp = x[3].clone(), x[3].clone()
                t0 = time.perf_counter()
                want = [*bullet_step_plain(mode, a, b, u, x[:2], bp), bp]
                torch.cuda.synchronize()
                if u is chal:
                    plain_ms = (time.perf_counter() - t0) * 1e3
                got = [*bullet_step(mode, a, b, u, x[:2], bk), bk]
            torch.cuda.synchronize()
            err = max(err, max(max_abs_err(g, w) for g, w in zip(got, want)))
        if err:
            raise AssertionError(f"bullet_step differs from its plain "
                                 f"version at n {n}")
        bf = x[3].clone()
        for mode, fn in (("cross", lambda: bullet_step("cross", a, b, x[:2])),
                         ("fold", lambda: bullet_step("fold", a, b, chal,
                                                      x[:2], bf))):
            ms = graph_ms(lambda: [fn() for _ in range(10)], 5) / 10
            eager = cuda_ms(fn, 20)
            bound = bullet_step_bound(mode, n, floor_ns)
            log(f"bullet_step (K6) {mode} n {n}: max_abs_err 0; {ms:.4f} ms "
                f"in a CUDA graph ({eager:.4f} ms launched one by one), "
                f"bound {bound['bound_ms']:.5f} ms ({bound['bound_by']})"
                + (f", plain {plain_ms:.1f} ms; the Fermat fold: "
                   f"{K6_EARLIER_FOLD_MS} ms" if mode == "fold" else ""))
            result[f"{mode}_{n}"] = dict(ms=ms, eager_ms=eager, **bound)
        result[f"fold_{n}"]["plain_ms"] = plain_ms
    log(f"bullet_step (K6) fold at u = 1, q - 1, 2^200 and random u (words "
        f"and bytes), n = {K6_SIZES}: equal to the plain version")
    # head and tail, one thread each
    v = rand_elems(gen, 8, dev)
    for mode, args in (("head", (chal, v[0], v[1])),
                       ("tail", (chal, v[0], v[1], v[2], v[3:6]))):
        got = bullet_step(mode, *args)
        want = bullet_step_plain(mode, *args)
        torch.cuda.synchronize()
        e = max_abs_err(got, want)
        if e:
            raise AssertionError(f"bullet_step {mode} differs from its plain "
                                 f"version")
        result[f"{mode}_ms"] = graph_ms(
            lambda: [bullet_step(mode, *args) for _ in range(10)], 5) / 10
        log(f"bullet_step (K6) {mode}: max_abs_err 0; "
            f"{result[f'{mode}_ms']:.4f} ms in a CUDA graph")
    result["max_abs_err"] = err
    return result


def check_no_fallback(dev, gen) -> None:
    """Forced launch failures (K5 given a lane count its launcher refuses,
    K4 given more points than its launcher takes) and forced build
    failures (K6 and K3 built into an empty directory by a compiler that
    fails) each raise, and no plain version runs in the kernel's place."""
    import tempfile

    import torch

    from spartan_tpu_torch import _build
    from spartan_tpu_torch.curve import edwards as ed
    from spartan_tpu_torch.curve import point_msm as pm
    from spartan_tpu_torch.curve import ristretto as dri
    from spartan_tpu_torch.ff import bullet_kernel as bk
    from spartan_tpu_torch.transcript import device as dt

    pts, s = random_points(gen, 8, dev), rand_elems(gen, 8, dev)
    plains = (pm.point_msm_plain, bk.bullet_step_plain, dri.compress_plain,
              dt.strobe_step_plain)
    calls = [f.cuda_calls for f in plains]

    def must_raise(what, fn):
        try:
            fn()
            torch.cuda.synchronize()
        except RuntimeError as e:
            log(f"forced {what} raised: {str(e).splitlines()[0]}")
        else:
            raise AssertionError(f"a forced {what} did not raise")

    saved_lanes = pm.lanes
    pm.lanes = lambda offsets: 3
    try:
        must_raise("K5 launch failure",
                   lambda: pm.point_msm(pts, s, [0, 8]))
    finally:
        pm.lanes = saved_lanes
    lib = _build.load("ristretto", dri._declare)
    saved_launch = lib.ristretto_encode_launch
    lib.ristretto_encode_launch = lambda p, o, k, st: saved_launch(
        p, o, 1 << 27, st)
    try:
        must_raise("K4 launch failure",
                   lambda: dri.compress(ed.unstack(pts)))
    finally:
        lib.ristretto_encode_launch = saved_launch
    for what, name, run in (
            ("K6 build failure", "bullet_step",
             lambda: bk.bullet_step("head", torch.zeros(
                 64, dtype=torch.uint8, device=dev), s[0], s[1])),
            ("K3 build failure", "keccak",
             lambda: dt.strobe_step(torch.zeros(200, dtype=torch.uint8,
                                                device=dev), None, [],
                                    True))):
        saved = (_build.nvcc, _build.build_dir, _build._libs.pop(name))
        with tempfile.TemporaryDirectory() as tmp:
            _build.nvcc = lambda: "false"
            _build.build_dir = lambda: tmp
            try:
                must_raise(what, run)
            finally:
                _build.nvcc, _build.build_dir, _build._libs[name] = saved
    if [f.cuda_calls for f in plains] != calls:
        raise AssertionError("a plain version ran in place of a kernel")


def bullet_round_times(dev) -> dict:
    """One host round (``bullet.host_round``) and one device round
    (``bullet.device_round``) at n = 2^4 ... 2^12 on the same inputs and
    transcript, each timed from a synchronised card to a synchronised
    card, medians of 5: the times that set ``bullet.DEVICE_MIN``.  Both
    must give the same L, R and folded a, b, G and blind_fin, and a
    device round must fetch once."""
    import statistics

    import torch

    from spartan_tpu_torch.commitments import MultiCommitGens
    from spartan_tpu_torch.core import edwards as hed
    from spartan_tpu_torch.core.field import P25519 as P
    from spartan_tpu_torch.core.merlin import Transcript
    from spartan_tpu_torch.curve import edwards as ed
    from spartan_tpu_torch.ff import fq
    from spartan_tpu_torch.protocols import bullet
    from spartan_tpu_torch.utils import rt

    def same(p, q):  # one point of the curve (projective coordinates)
        return (p.X * q.Z - q.X * p.Z) % P == 0 and \
            (p.Y * q.Z - q.Y * p.Z) % P == 0

    gen = torch.Generator().manual_seed(77)
    q_pt = hed.BASEPOINT.mul(123456789)
    rounds = {}
    for log_n in ROUND_LOGS:
        n = 1 << log_n
        gens = MultiCommitGens(n, b"chip_smoke bullet")
        G, qh = gens.points(dev), ed.stack(ed.from_host([q_pt, gens.h], dev))
        a, b = rand_elems(gen, n, dev), rand_elems(gen, n, dev)
        a_i, b_i = fq.decode_to_ints(a), fq.decode_to_ints(b)
        blinds = fq.encode_ints([12345, 67890], dev)
        times = {"host": [], "device": []}
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            h = bullet.host_round(Transcript(b"round"), q_pt, gens.h, a_i,
                                  b_i, gens.G, 12345, 67890, 99, dev)
            times["host"].append(time.perf_counter() - t0)
            bf = fq.encode_ints([99], dev)[0]
            torch.cuda.synchronize()
            f0 = rt.fetches
            t0 = time.perf_counter()
            d = bullet.device_round(Transcript(b"round"), a, b, G, qh,
                                    blinds, bf)
            torch.cuda.synchronize()
            times["device"].append(time.perf_counter() - t0)
            if rt.fetches - f0 != 1:
                raise AssertionError(f"a device round at n {n} fetched "
                                     f"{rt.fetches - f0} times")
        got = (fq.decode_to_ints(d[0]), fq.decode_to_ints(d[1]),
               fq.decode_to_ints(bf[None])[0], d[3], d[4])
        if got != (h[0], h[1], h[3], h[4], h[5]) or not all(
                same(p, q) for p, q in zip(ed.to_host(ed.unstack(d[2])),
                                           h[2])):
            raise AssertionError(f"the device round at n {n} differs from "
                                 f"the host round")
        rounds[n] = {p: statistics.median(v) * 1e3 for p, v in times.items()}
        log(f"bullet round n {n}: host {rounds[n]['host']:.3f} ms, device "
            f"{rounds[n]['device']:.3f} ms (medians of 5; each device round "
            f"one fetch; the same L, R and folded values)")
    wins = [n // 2 for n in rounds
            if all(rounds[m]["device"] < rounds[m]["host"]
                   for m in rounds if m >= n)]
    measured = min(wins) if wins else None
    log(f"bullet rounds: the device round wins from n/2 = {measured} on; "
        f"bullet.DEVICE_MIN['cuda'] = {bullet.DEVICE_MIN['cuda']}")
    return {"round_ms": rounds, "device_wins_from_half": measured,
            "device_min": bullet.DEVICE_MIN["cuda"]}


class FetchesPerCall:
    """Counts the fetches (utils/rt.py) of each call of the device
    prover's three entry points while active."""

    def __enter__(self):
        from spartan_tpu_torch.protocols import device_prover as dp
        from spartan_tpu_torch.utils import rt

        self.calls = []
        self._orig = {}
        for name in ("zk_sumcheck_phase_device",
                     "prove_product_layers_device", "dotproduct_log_device"):
            fn = getattr(dp, name)
            self._orig[name] = fn

            def counted(*a, _fn=fn, _name=name, **k):
                f0 = rt.fetches
                out = _fn(*a, **k)
                self.calls.append((_name, rt.fetches - f0))
                return out

            setattr(dp, name, counted)
        return self

    def __exit__(self, *exc):
        from spartan_tpu_torch.protocols import device_prover as dp

        for name, fn in self._orig.items():
            setattr(dp, name, fn)

    def check(self, what: str) -> dict:
        per = collections.Counter(name for name, _ in self.calls)
        bad = [c for c in self.calls if c[1] != 1]
        if not self.calls or bad:
            raise AssertionError(f"{what}: device prover calls and their "
                                 f"fetches {self.calls}")
        return dict(per)


GATED_KERNELS = ("row_msm", "fold_evals", "fold_evals_device_r",
                 "strobe_step", "ristretto_compress", "point_msm",
                 "bullet_step")


def device_prover_paths(dev, inst, vars_a, inputs_a, nizk_ctx,
                        snark_ctx) -> dict:
    """The 2^20 NIZK and SNARK proved again under
    SPARTAN_TPU_DEVICE_PROVER=1, with the host path's transcript labels
    and tape seed: the bytes must equal the host path's (same process)
    and verify.  Counters reset just before each prove and read just
    after; each device ZK phase and product proof must fetch once."""
    import torch

    from spartan_tpu_torch import serialize as ser
    from spartan_tpu_torch.api import NIZK, SNARK
    from spartan_tpu_torch.core.merlin import Transcript
    from spartan_tpu_torch.utils import rt, timer

    def run(what, prove, spans):
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_stats()
        start_bytes = torch.cuda.memory_allocated()
        timer.totals.clear()
        f0, s0 = rt.snapshot()
        reset_counts()
        with FetchesPerCall() as per_call:
            t0 = time.perf_counter()
            proof = prove()
            torch.cuda.synchronize()
            prove_s = time.perf_counter() - t0
        launches = read_counts()
        f1, s1 = rt.snapshot()
        missing = [k for k in GATED_KERNELS if launches[k] <= 0]
        if missing:
            raise AssertionError(f"{what}: {missing} never launched: "
                                 f"{launches}")
        return proof, {
            "prove_s": prove_s, "spans_s": {k: timer.totals.get(k)
                                            for k in spans},
            "fetches": f1 - f0, "fetch_stall_s": s1 - s0,
            "device_prover_calls": per_call.check(what),
            "peak_device_bytes": torch.cuda.max_memory_allocated(),
            "device_bytes_at_start": start_bytes,
            "device_mallocs": new_segments(mem0), "launches": launches}

    os.environ["SPARTAN_TPU_DEVICE_PROVER"] = "1"
    try:
        nizk, nizk_sum = run("nizk", lambda: NIZK.prove(
            inst, vars_a, inputs_a, nizk_ctx["gens"],
            Transcript(b"chip_smoke"), _tape_seed=7), NIZK_SPANS)
        snark, snark_sum = run("snark", lambda: SNARK.prove(
            inst, snark_ctx["comm"], snark_ctx["decomm"], vars_a, inputs_a,
            snark_ctx["gens"], Transcript(b"chip_smoke_snark"),
            _tape_seed=7), SNARK_SPANS)
    finally:
        del os.environ["SPARTAN_TPU_DEVICE_PROVER"]
    if ser.nizk_to_bytes(nizk) != nizk_ctx["blob"]:
        raise AssertionError("the device prover's NIZK bytes differ from "
                             "the host path's")
    if ser.snark_to_bytes(snark) != snark_ctx["blob"]:
        raise AssertionError("the device prover's SNARK bytes differ from "
                             "the host path's")
    t0 = time.perf_counter()
    nizk.verify(inst, inputs_a, Transcript(b"chip_smoke"), nizk_ctx["gens"])
    nizk_sum["verify_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    snark.verify(snark_ctx["comm"], inputs_a,
                 Transcript(b"chip_smoke_snark"), snark_ctx["gens"])
    snark_sum["verify_s"] = time.perf_counter() - t0
    out = {"nizk": nizk_sum, "snark": snark_sum,
           "bytes_equal_host_path": True}
    log("device_prover " + json.dumps(out))
    return out


def host_rounds_paths(inst, vars_a, inputs_a, nizk_ctx, snark_ctx) -> dict:
    """The 2^20 NIZK and SNARK proved again in this process with every
    bullet round on the host (DEVICE_MIN infinite): the bytes must equal
    the default path's.  Walls and the dot-product-log spans beside the
    default path's."""
    import math

    import torch

    from spartan_tpu_torch import serialize as ser
    from spartan_tpu_torch.api import NIZK, SNARK
    from spartan_tpu_torch.core.merlin import Transcript
    from spartan_tpu_torch.protocols import bullet
    from spartan_tpu_torch.utils import rt, timer

    saved = bullet.DEVICE_MIN["cuda"]
    bullet.DEVICE_MIN["cuda"] = math.inf
    out = {}
    try:
        for what, prove, ser_fn, ctx in (
                ("nizk", lambda: NIZK.prove(
                    inst, vars_a, inputs_a, nizk_ctx["gens"],
                    Transcript(b"chip_smoke"), _tape_seed=7),
                 ser.nizk_to_bytes, nizk_ctx),
                ("snark", lambda: SNARK.prove(
                    inst, snark_ctx["comm"], snark_ctx["decomm"], vars_a,
                    inputs_a, snark_ctx["gens"],
                    Transcript(b"chip_smoke_snark"), _tape_seed=7),
                 ser.snark_to_bytes, snark_ctx)):
            timer.totals.clear()
            f0 = rt.fetches
            reset_counts()
            t0 = time.perf_counter()
            proof = prove()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = read_counts()
            if ser_fn(proof) != ctx["blob"]:
                raise AssertionError(f"the {what} bytes with host bullet "
                                     f"rounds differ from the default "
                                     f"path's")
            if launches["point_msm"] or launches["bullet_step"]:
                raise AssertionError(f"{what} with host rounds launched "
                                     f"K5 or K6: {launches}")
            out[what] = {"prove_s": wall, "fetches": rt.fetches - f0,
                         "dotproduct_log_s": timer.totals.get(
                             "polyeval::dotproduct_log")}
    finally:
        bullet.DEVICE_MIN["cuda"] = saved
    out["bytes_equal_default_path"] = True
    log("host_rounds " + json.dumps(out))
    return out


# The multi-device prover (parallel/): the 2^20 NIZK and SNARK again
# under a mesh that lists the one card SHARDS times, so each shard is a
# real launch of B1 or B2 at its own size; then the two-tier collectives
# on the card listed DCN_GRID[0] x DCN_GRID[1] times.
SHARDS = 4
DCN_GRID = (2, 4)
DCN_POINTS = 1024
DCN_TABLE = 1 << 16


def sharded_paths(dev, gen, inst, vars_a, inputs_a, nizk_ctx, snark_ctx,
                  nizk_sum, snark_sum) -> dict:
    """The 2^20 NIZK proved and verified, and the SNARK encoded, proved
    and verified, under ``Mesh([dev] * SHARDS)``: the commitment and
    proof bytes must equal the default path's from this run, and sharded
    rounds must have run in phase one (4 tables at n/SHARDS), phase two
    (2 at 2n/SHARDS) and the product layers.  Counters reset just before
    each of the three runs and read just after; B1's launches are held
    against the plain version on their first, middle and last rows, B1
    and B2 bit for bit at the first sharded shapes, and SHARDS launches
    at n/SHARDS are timed beside one launch at n."""
    import torch

    from spartan_tpu_torch import serialize as ser
    from spartan_tpu_torch.api import NIZK, SNARK
    from spartan_tpu_torch.commitments import MultiCommitGens
    from spartan_tpu_torch.core.merlin import Transcript
    from spartan_tpu_torch.curve import row_msm as rm
    from spartan_tpu_torch.ff import round_kernel as rk
    from spartan_tpu_torch.parallel import context as pctx
    from spartan_tpu_torch.parallel.mesh import Mesh
    from spartan_tpu_torch.poly import dense
    from spartan_tpu_torch.utils import rt, timer

    mesh = Mesh([dev] * SHARDS)
    n = inst.inst.num_cons

    def run(what, fn, spans):
        torch.cuda.reset_peak_memory_stats()
        start_bytes = torch.cuda.memory_allocated()
        timer.totals.clear()
        mesh.sharded_rounds.clear()
        mesh.msm_blocks.clear()
        f0 = rt.fetches
        reset_counts()
        with RowMsmRows() as rows, pctx.use_mesh(mesh):
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = read_counts()
        shapes = collections.Counter(rk.fold_evals.launches)
        block_shapes = sorted({k[1:] for k in mesh.msm_blocks})
        rows.check(f"sharded {what}", block_shapes)
        return out, shapes, {
            "wall_s": wall, "spans_s": {k: timer.totals.get(k)
                                        for k in spans},
            "fetches": rt.fetches - f0,
            "peak_device_bytes": torch.cuda.max_memory_allocated(),
            "device_bytes_at_start": start_bytes, "launches": launches,
            "sharded_rounds": sorted([*k, c] for k, c in
                                     mesh.sharded_rounds.items()),
            "msm_blocks": sorted([*k, c] for k, c in
                                 mesh.msm_blocks.items())}

    nizk, nizk_shapes, nizk_run = run("nizk prove", lambda: NIZK.prove(
        inst, vars_a, inputs_a, nizk_ctx["gens"], Transcript(b"chip_smoke"),
        _tape_seed=7), NIZK_SPANS)
    (comm, decomm), _, encode_run = run("snark encode", lambda: SNARK.encode(
        inst, snark_ctx["gens"]), ["SNARK::encode"])
    snark, snark_shapes, snark_run = run("snark prove", lambda: SNARK.prove(
        inst, comm, decomm, vars_a, inputs_a, snark_ctx["gens"],
        Transcript(b"chip_smoke_snark"), _tape_seed=7), SNARK_SPANS)

    if ser.nizk_to_bytes(nizk) != nizk_ctx["blob"]:
        raise AssertionError("the sharded NIZK bytes differ from the "
                             "default path's")
    if (ser.commitment_to_bytes(comm)
            != ser.commitment_to_bytes(snark_ctx["comm"])):
        raise AssertionError("the sharded SNARK commitment differs from "
                             "the default path's")
    if ser.snark_to_bytes(snark) != snark_ctx["blob"]:
        raise AssertionError("the sharded SNARK bytes differ from the "
                             "default path's")
    t0 = time.perf_counter()
    nizk.verify(inst, inputs_a, Transcript(b"chip_smoke"), nizk_ctx["gens"])
    nizk_run["verify_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    snark.verify(comm, inputs_a, Transcript(b"chip_smoke_snark"),
                 snark_ctx["gens"], device=dev)
    snark_run["verify_s"] = time.perf_counter() - t0

    # sharded rounds in phase one, phase two and the product layers: each
    # phase's first round at the shards' size, once a shard
    local = n // SHARDS
    for what, shapes, key in (
            ("phase one", nizk_shapes, ("cubic", 1, local, "evals")),
            ("phase two", nizk_shapes, ("quad", 1, 2 * local, "evals")),
            ("SNARK phase one", snark_shapes, ("cubic", 1, local, "evals"))):
        if shapes[key] != SHARDS:
            raise AssertionError(f"{what} under the mesh: {shapes[key]} "
                                 f"launches at {key}, not {SHARDS}")
    layer = [k for k in snark_run["sharded_rounds"] if k[0] == "layer"]
    if not layer:
        raise AssertionError("no sharded product-layer round ran")
    for what, r in (("nizk", nizk_run), ("snark", snark_run)):
        if min(r["launches"]["row_msm"], r["launches"]["fold_evals"]) <= 0:
            raise AssertionError(f"sharded {what}: B1 or B2 never "
                                 f"launched: {r['launches']}")

    # B1 and B2 against their plain versions at the first sharded shapes
    check_fold_evals(dev, gen, [(4, local), (2, 2 * local)])
    prod = max((k for k in snark_shapes if k[0] == "cubic_prod"),
               key=lambda k: k[1] * k[2])
    check_cubic_prod(dev, gen, [prod[1:3]])
    left, right = dense.factored_lens(n.bit_length() - 1)
    L, R = 1 << left, 1 << right  # the witness commitment's rows
    check_row_msm(dev, gen, [(L // SHARDS, R)])

    # SHARDS launches at n/SHARDS beside one at n: B2's fold-and-evals
    # on phase one's four tables, B1 on the witness rows
    r = 10 ** 70 + 33
    whole = [rand_elems(gen, n, dev) for _ in range(4)]
    parts = [[t[k::SHARDS].contiguous() for t in whole]
             for k in range(SHARDS)]
    b2_one = graph_ms(lambda: rk.fold_evals(whole, r, "fold_evals"), 5)
    b2_shards = graph_ms(lambda: [rk.fold_evals(p, r, "fold_evals")
                                  for p in parts], 5)
    tab = MultiCommitGens(R, b"chip_smoke").msm_table(dev)
    s = rand_elems(gen, L * R, dev).reshape(L, R, 8)
    lb = L // SHARDS
    b1_one = cuda_ms(lambda: rm.row_msm(s, tab), 3)
    b1_shards = cuda_ms(lambda: [rm.row_msm(s[k * lb:(k + 1) * lb], tab)
                                 for k in range(SHARDS)], 3)
    per_round = {
        "fold_evals_4_tables_one_launch_at_n_ms": b2_one,
        f"fold_evals_4_tables_{SHARDS}_launches_at_n_over_{SHARDS}_ms":
            b2_shards,
        "row_msm_one_launch_ms": b1_one,
        f"row_msm_{SHARDS}_blocks_ms": b1_shards,
        "rows": [L, R], "n": n}
    log(f"sharded B2 at {n}: one launch {b2_one:.4f} ms, {SHARDS} at "
        f"{n // SHARDS} {b2_shards:.4f} ms (CUDA graph); B1 at ({L}, {R}): "
        f"one launch {b1_one:.3f} ms, {SHARDS} blocks of {lb} rows "
        f"{b1_shards:.3f} ms")

    out = {"shards": SHARDS, "devices": [str(d) for d in mesh.devices],
           "nizk_prove": nizk_run, "snark_encode": encode_run,
           "snark_prove": snark_run,
           "default_path": {
               "nizk_prove_s": nizk_sum["prove_s"],
               "nizk_verify_s": nizk_sum["verify_s"],
               "nizk_phases_s": nizk_sum["phases_s"],
               "nizk_peak_device_bytes": nizk_sum["peak_device_bytes"],
               "snark_encode_s": snark_sum["encode_s"],
               "snark_prove_s": snark_sum["prove_s"],
               "snark_verify_s": snark_sum["verify_s"],
               "snark_spans_s": snark_sum["spans_s"],
               "snark_peak_device_bytes": snark_sum["peak_device_bytes"]},
           "launch_cost": per_round, "bytes_equal_default_path": True}
    log("sharded " + json.dumps(out))
    return out


def dcn_check(dev, gen) -> dict:
    """The two-tier collectives on ``[dev] * 8`` shaped DCN_GRID:
    ``all_reduce_field`` and ``sum_mod_q_two_tier``
    against python ints, ``msm_two_tier`` (K5 on each device's block)
    against the host MSM."""
    import torch

    from spartan_tpu_torch.core import edwards as hed
    from spartan_tpu_torch.core import ristretto as hri
    from spartan_tpu_torch.core.field import Q
    from spartan_tpu_torch.curve import edwards as ed
    from spartan_tpu_torch.curve import point_msm as pm
    from spartan_tpu_torch.ff import fq, limb
    from spartan_tpu_torch.parallel import dcn

    hosts, per = DCN_GRID
    mesh2d = dcn.make_mesh2d(hosts, per, [dev] * (hosts * per))
    vals = fq.decode_to_ints(rand_elems(gen, hosts * per * 3, dev))
    partials = [fq.encode_ints(vals[3 * k:3 * k + 3], dev)
                for k in range(hosts * per)]
    want = [sum(vals[3 * k + i] for k in range(hosts * per)) % Q
            for i in range(3)]
    if fq.decode_to_ints(dcn.all_reduce_field(partials, mesh2d)) != want:
        raise AssertionError("all_reduce_field differs from the python-int "
                             "sum")
    table = rand_elems(gen, DCN_TABLE, dev)
    got = fq.decode_to_ints(dcn.sum_mod_q_two_tier(mesh2d)(table))
    if got != [sum(fq.decode_to_ints(table)) % Q]:
        raise AssertionError("sum_mod_q_two_tier differs from the "
                             "python-int sum")
    pts = random_points(gen, DCN_POINTS, dev)
    scalars = rand_elems(gen, DCN_POINTS, dev)
    pm.point_msm.launches = 0
    t0 = time.perf_counter()
    out = dcn.msm_two_tier(mesh2d)(scalars, pts)
    torch.cuda.synchronize()
    msm_s = time.perf_counter() - t0
    launches = pm.point_msm.launches
    got_pt = ed.to_host(ed.unstack(out))[0]
    want_pt = hed.msm(limb.limbs_to_ints(scalars),
                      ed.to_host(ed.unstack(pts)))
    if hri.encode(got_pt) != hri.encode(want_pt):
        raise AssertionError("msm_two_tier differs from the host MSM")
    if launches != hosts * per:
        raise AssertionError(f"msm_two_tier launched K5 {launches} times, "
                             f"not {hosts * per}")
    result = {"grid": list(DCN_GRID), "field_elements": 3,
              "table": DCN_TABLE, "points": DCN_POINTS,
              "msm_two_tier_s": msm_s, "point_msm_launches": launches,
              "blocks": sorted([*k, c] for k, c in
                               mesh2d.msm_blocks.items())}
    log("dcn " + json.dumps(result))
    return result


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import spartan_tpu_torch  # noqa: F401  (fails outside the repo)

    card = smi_line()
    log(f"card: {card}")
    log(f"torch.cuda.get_device_name(0): {torch.cuda.get_device_name(0)}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(20261016)

    t_start = time.perf_counter()
    build_kernels()
    log(f"kernels built in {time.perf_counter() - t_start:.1f} s")
    msm = check_row_msm(dev, gen, MSM_SHAPES)
    fold = check_fold_evals(dev, gen, ROUND_CASES)
    fold.update(check_round_chains(dev, gen))
    prod = check_cubic_prod(dev, gen)
    floor = launch_floor_ms(dev)
    k3 = check_strobe_step(dev, gen, floor)
    k4 = check_compress(dev, gen, encode_latencies(dev), floor)
    fold["device_r"] = check_fold_evals_device_r(dev, gen)
    k5 = check_point_msm(dev, gen)
    k6 = check_bullet_step(dev, gen)
    k7 = check_to_mont(dev, gen)
    check_no_fallback(dev, gen)
    rounds = bullet_round_times(dev)
    golden(dev)
    golden_snark(dev)
    inst, vars_a, inputs_a, setup_s = make_instance(dev, LOG_N)
    summary, nizk_ctx = nizk_main_path(dev, inst, vars_a, inputs_a, setup_s)
    snark, prod_shapes, snark_ctx = snark_main_path(dev, inst, vars_a,
                                                    inputs_a)
    prod_chain = check_product_layer_chain(dev, prod_shapes)
    if (prod_chain["launches_per_prove"]
            != snark["launches"]["prove"]["fold_evals_by_comb"]["cubic_prod"]):
        raise AssertionError("the replay's launches differ from the prove's")
    for what, counts in (("NIZK", summary["launches"]),
                         ("SNARK", snark["launches"]["prove"])):
        log(f"default-path launches, {what} prove: K5 {counts['point_msm']},"
            f" K6 {counts['bullet_step']} "
            f"{counts['bullet_step_by_mode']}")
    host_rounds = host_rounds_paths(inst, vars_a, inputs_a, nizk_ctx,
                                    snark_ctx)
    gated = device_prover_paths(dev, inst, vars_a, inputs_a, nizk_ctx,
                                snark_ctx)
    # B1 under the gate only where the host path launches it (the witness
    # and Spark commitments): never with the ZK rounds' tape secrets
    for what, host in (("nizk", summary["launches"]),
                       ("snark", snark["launches"]["prove"])):
        if gated[what]["launches"]["row_msm"] != host["row_msm"]:
            raise AssertionError(f"B1 under the gate in the {what} prove: "
                                 f"{gated[what]['launches']['row_msm']} "
                                 f"launches, the host path's "
                                 f"{host['row_msm']}")
    # after the replay's comparison above: the sharded runs reset the
    # counters again
    sharded = sharded_paths(dev, gen, inst, vars_a, inputs_a, nizk_ctx,
                            snark_ctx, summary, snark)
    dcn = dcn_check(dev, gen)
    by_path = {
        name: {"nizk_prove": summary["launches"][name],
               "snark_encode": snark["launches"]["encode"][name],
               "snark_prove": snark["launches"]["prove"][name],
               "nizk_prove_device_prover": gated["nizk"]["launches"][name],
               "snark_prove_device_prover":
                   gated["snark"]["launches"][name],
               "nizk_prove_sharded":
                   sharded["nizk_prove"]["launches"][name],
               "snark_encode_sharded":
                   sharded["snark_encode"]["launches"][name],
               "snark_prove_sharded":
                   sharded["snark_prove"]["launches"][name]}
        for name in ("row_msm", "fold_evals", "fold_evals_device_r",
                     "strobe_step", "ristretto_compress", "point_msm",
                     "bullet_step", "to_mont")}
    timed = PROD_TIMED + ("fold_evals",)
    kernels = [
        dict(name="row_msm", route="cuda",
             source="spartan_tpu_torch/csrc/row_msm.cu",
             replaces="spartan_tpu/curve/pallas_msm.py:275",
             launches=summary["launches"]["row_msm"], library_ms=None,
             launches_by_path=by_path["row_msm"],
             spark_shapes=snark["row_msm_on_spark_tables"],
             sharded_blocks={k: sharded[k]["msm_blocks"] for k in (
                 "nizk_prove", "snark_encode", "snark_prove")},
             sharded_launch_cost=sharded["launch_cost"], **msm),
        dict(name="fold_evals", route="cuda",
             source="spartan_tpu_torch/csrc/fold_evals.cu",
             replaces="spartan_tpu/ff/pallas_kernels.py:211",
             launches=summary["launches"]["fold_evals"], library_ms=None,
             launches_by_path=by_path["fold_evals"],
             device_r_launches_by_path=by_path["fold_evals_device_r"],
             sharded_rounds={k: sharded[k]["sharded_rounds"] for k in (
                 "nizk_prove", "snark_prove")},
             **fold),
        dict(name="fold_evals[cubic_prod, batched]", route="cuda",
             source="spartan_tpu_torch/csrc/fold_evals.cu",
             replaces="spartan_tpu/ff/pallas_kernels.py:211",
             launches=snark["launches"]["prove"]["fold_evals_by_comb"][
                 "cubic_prod"],
             library_ms=None, shape=list(timed), modes=prod,
             **prod["fold_evals"], **prod_chain),
        dict(name="strobe_step (keccak-f[1600])", route="cuda",
             source="spartan_tpu_torch/csrc/keccak.cu",
             replaces="spartan_tpu/transcript/device.py:89",
             launches=gated["nizk"]["launches"]["strobe_step"],
             launches_by_path=by_path["strobe_step"], library_ms=None,
             **k3),
        dict(name="ristretto_compress", route="cuda",
             source="spartan_tpu_torch/csrc/ristretto.cu",
             replaces="spartan_tpu/curve/ristretto.py:26",
             launches=summary["launches"]["ristretto_compress"],
             launches_by_path=by_path["ristretto_compress"],
             library_ms=None, **k4),
        dict(name="point_msm", route="cuda",
             source="spartan_tpu_torch/csrc/point_msm.cu",
             replaces="spartan_tpu/curve/edwards.py:100, "
                      "spartan_tpu/curve/msm.py:147",
             launches=summary["launches"]["point_msm"],
             launches_by_path=by_path["point_msm"], library_ms=None,
             dcn=dcn, shape=list(K5_CASES[0][1]), max_abs_err=0,
             ms=k5["cross_2048"]["ms"], plain_ms=k5["cross_2048"]["plain_ms"],
             bound_ms=k5["cross_2048"]["bound_ms"],
             bound_by=k5["cross_2048"]["bound_by"],
             chain_floor_ms=k5["cross_2048"]["chain_floor_ms"], cases=k5),
        dict(name="bullet_step", route="cuda",
             source="spartan_tpu_torch/csrc/bullet_step.cu",
             replaces="spartan_tpu/protocols/bullet.py:89, "
                      "spartan_tpu/protocols/device_prover.py:682",
             launches=summary["launches"]["bullet_step"],
             launches_by_path=by_path["bullet_step"], library_ms=None,
             shape=[2048, "fold"], max_abs_err=k6["max_abs_err"],
             ms=k6["fold_2048"]["ms"], plain_ms=k6["fold_2048"]["plain_ms"],
             bound_ms=k6["fold_2048"]["bound_ms"],
             bound_by=k6["fold_2048"]["bound_by"], modes=k6,
             bullet_rounds=rounds, host_rounds=host_rounds),
        dict(name="fq_elementwise[to_mont]", route="cuda",
             source="spartan_tpu_torch/csrc/fq_elementwise.cu",
             replaces=None, launches=summary["launches"]["to_mont"],
             launches_by_path=by_path["to_mont"], library_ms=None, **k7),
    ]
    log(f"chip_smoke wall: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
