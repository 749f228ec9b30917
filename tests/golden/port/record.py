"""The JAX package's values that the port's tests compare with, recorded.

The port's tests (``tests/test_torch_*.py``) hold the port to the JAX
package.  Running the package's jitted functions costs XLA compiles, and
the package does not change, so its outputs at the tests' shapes, on the
tests' seeded inputs, are recorded here once: one ``<name>.npz`` for a
test and its parameters.  The tests load them with ``load`` and compile
nothing.  ``tests/test_torch_fixtures.py`` (``slow``) recomputes every
fixture with the JAX package and holds it equal to its file.

Stored forms: a value of up to 256 bits as its 32 little-endian bytes
(``uint8``, last axis 32; ``from_ints``/``to_ints``), wire bytes as a
``uint8`` vector, a JAX array as it is.  The inputs come from the test
modules' own helpers, so both sides see the same values.

Run from the root of the repo to write every fixture, or those named:

    python tests/golden/port/record.py [NAME ...]
"""

import contextlib
import functools
import os
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
TESTS = HERE.parents[1]

RECORDERS = {}  # fixture name -> function computing its arrays


def path(name: str) -> Path:
    return HERE / f"{name}.npz"


def load(name: str) -> dict:
    with np.load(path(name)) as z:
        return {k: z[k] for k in z.files}


def from_ints(xs) -> np.ndarray:
    """Nested lists of ints in [0, 2^256) -> uint8 (..., 32)."""
    a = np.asarray(xs, dtype=object)
    out = np.zeros(a.shape + (32,), np.uint8)
    for i, v in np.ndenumerate(a):
        out[i] = np.frombuffer(int(v).to_bytes(32, "little"), np.uint8)
    return out


def to_ints(a: np.ndarray):
    """uint8 (..., 32) -> nested lists of python ints (an int for (32,))."""
    vals = [int.from_bytes(r.tobytes(), "little") for r in a.reshape(-1, 32)]
    return np.array(vals, dtype=object).reshape(a.shape[:-1]).tolist()


def from_bytes(blob: bytes) -> np.ndarray:
    return np.frombuffer(blob, np.uint8).copy()


def _recorder(name: str, **params):
    def register(fn):
        RECORDERS[name.format(**params)] = functools.partial(fn, **params)
        return fn
    return register


def _jax_mont(ints):
    import jax.numpy as jnp

    from spartan_tpu.ff import fq as jfq

    return jnp.asarray(jfq.encode_ints_mont(ints))


def _jax_decoded(t):
    """(B, ..., 16) Montgomery -> lists of canonical ints per leading index."""
    from spartan_tpu.ff import fq as jfq

    return [jfq.decode_to_ints(x) for x in t]


def _jax_scalars(es):
    """A round's evals, each a (16,) Montgomery scalar -> ints."""
    from spartan_tpu.ff import fq as jfq

    return [jfq.decode_to_ints(e[None])[0] for e in es]


# tests/test_torch_round.py


@_recorder("round-{ntab}-{n}", ntab=4, n=8)
@_recorder("round-{ntab}-{n}", ntab=4, n=64)
@_recorder("round-{ntab}-{n}", ntab=2, n=8)
def _round(ntab, n):
    """``sumcheck._evals_cubic_additive`` (4 tables) or ``_evals_quad``
    (2) on the tables, ``dense.bound_var_top`` by r, the evals again."""
    from spartan_tpu.poly import dense as jdense
    from spartan_tpu.protocols import sumcheck as jsc
    from test_torch_round import _round_inputs

    ints, r = _round_inputs(ntab, n)
    tabs = [_jax_mont(t) for t in ints]
    evals_fn = jsc._evals_cubic_additive if ntab == 4 else jsc._evals_quad
    folded = [jdense.bound_var_top(T, _jax_mont([r])[0]) for T in tabs]
    return dict(evals=from_ints(_jax_scalars(evals_fn(*tabs))),
                tables=from_ints(_jax_decoded(folded)),
                folded_evals=from_ints(_jax_scalars(evals_fn(*folded))),
                folded=np.stack([np.asarray(T) for T in folded]))


# tests/test_torch_r1cs.py


@_recorder("r1cs-synthetic")
def _r1cs_synthetic():
    """``R1CSShape.produce_synthetic(16, 16, 2, seed=99)``: A, B and C as
    rows, columns and values, the digest, the satisfying assignment and
    the inputs, and ``evaluate(rx, ry)`` at the test's point."""
    from spartan_tpu.r1cs.shape import R1CSShape
    from test_torch_r1cs import _eval_point

    inst, vars_i, inputs_i = R1CSShape.produce_synthetic(16, 16, 2, seed=99)
    out = {}
    for name in "ABC":
        m = getattr(inst, name)
        out.update({f"{name}_rows": np.asarray(m._rows_np),
                    f"{name}_cols": np.asarray(m._cols_np),
                    f"{name}_vals": np.asarray(m.vals)})
    return dict(out, digest=from_bytes(inst.get_digest()),
                vars=from_ints(vars_i), inputs=from_ints(inputs_i),
                evaluated=from_ints(inst.evaluate(*_eval_point())))


# tests/test_torch_spark.py


@_recorder("spark-cubic-prod")
def _spark_cubic_prod():
    """The product tree's batched round step: ``_evals_cubic_batched`` on
    three (5, 8) tables, ``_bound_var_top_batched`` by r, the evals again."""
    from spartan_tpu.protocols import product_tree as jpt
    from test_torch_spark import _cubic_prod_inputs

    ints, r = _cubic_prod_inputs()
    tabs = [_jax_mont([v for row in t for v in row]).reshape(
        len(t), len(t[0]), 16) for t in ints]
    folded = [jpt._bound_var_top_batched(T, _jax_mont([r])[0]) for T in tabs]
    return dict(evals=from_ints(_jax_decoded(jpt._evals_cubic_batched(*tabs))),
                tables=from_ints([_jax_decoded(t) for t in folded]),
                folded_evals=from_ints(_jax_decoded(
                    jpt._evals_cubic_batched(*folded))))


@_recorder("spark-dense-rep")
def _spark_dense_rep():
    """``spark.multi_sparse_to_dense_rep`` of the golden instance's A, B, C
    (16 x 16, 2 inputs, seed 424242): the address-timestamp arrays of its
    rows and columns, its values and its combined tables."""
    from spartan_tpu import api as japi
    from spartan_tpu.protocols import spark as jspark

    jinst, _, _ = japi.Instance.produce_synthetic_r1cs(16, 16, 2,
                                                       seed=424242)
    j = jspark.multi_sparse_to_dense_rep(
        [jinst.inst.A, jinst.inst.B, jinst.inst.C])
    out = {f"{side}_{name}": np.asarray(getattr(getattr(j, side), name))
           for side in ("row", "col")
           for name in ("ops_addr_int", "read_ts_int", "audit_ts_int")}
    return dict(out, val=np.asarray(j.val), batch_size=np.asarray(j.batch_size),
                comb_ops=np.asarray(j.comb_ops),
                comb_mem=np.asarray(j.comb_mem))


# tests/test_torch_point_msm.py


@_recorder("point-msm-scalar-mul")
def _point_msm_scalar_mul():
    """``curve/edwards.py``: ``sum_reduce(scalar_mul(points, scalars))`` at
    4 points; the sum's projective coordinates X, Y, Z, T."""
    import jax.numpy as jnp

    from spartan_tpu.curve import edwards as jed
    from spartan_tpu.ff import limb as jlimb
    from test_torch_point_msm import _scalar_mul_inputs

    pts, ks = _scalar_mul_inputs()
    s = jnp.asarray(jlimb.ints_to_limbs(ks))
    want = jed.to_host(jed.PointArray(*(c[None] for c in jed.sum_reduce(
        jed.scalar_mul(jed.from_host(pts), s)))))[0]
    return dict(point=from_ints([want.X, want.Y, want.Z, want.T]))


# tests/test_torch_bullet.py


@_recorder("bullet-rounds-{n}", n=8)
@_recorder("bullet-rounds-{n}", n=16)
def _bullet_rounds(n):
    """``BulletReductionProof.prove`` on its host path: L and R, the
    scalars a_hat, b_hat, blind_fin, the encodings of g_hat and Gamma_hat,
    and the transcript's next challenge (``post``)."""
    from spartan_tpu import commitments as jcom
    from spartan_tpu.core import merlin as jmerlin
    from spartan_tpu.core import ristretto as jri
    from spartan_tpu.poly import dense as jdense
    from spartan_tpu.protocols import bullet as jbullet
    from test_torch_bullet import _rounds_inputs

    a_i, b_i, blinds, q_pt, label = _rounds_inputs(n)
    tj = jmerlin.Transcript(b"bullet")
    jg = jcom.MultiCommitGens(n, label)
    proof, gamma, a_hat, b_hat, g_hat, bf = jbullet.BulletReductionProof.prove(
        tj, q_pt, jg.device_G, jg.h, jdense.from_ints(a_i),
        jdense.from_ints(b_i), 4242, blinds)
    return dict(L_vec=np.stack([from_bytes(b) for b in proof.L_vec]),
                R_vec=np.stack([from_bytes(b) for b in proof.R_vec]),
                scalars=from_ints([a_hat, b_hat, bf]),
                g_hat=from_bytes(jri.encode(g_hat)),
                gamma=from_bytes(jri.encode(gamma)),
                post=from_ints(tj.challenge_scalar(b"post")))


@_recorder("bullet-dplog")
def _bullet_dplog():
    """``DotProductProofLog.prove`` on its host path at n = 16, tape seed
    31: the proof's bytes, Cx, Cy and the transcript's ``post``."""
    from spartan_tpu import serialize as jser
    from spartan_tpu.core import merlin as jmerlin
    from spartan_tpu.poly import dense as jdense
    from spartan_tpu.protocols import dotproduct_log as jdl
    from spartan_tpu.protocols import sigma as jsigma
    from test_torch_bullet import _dplog_inputs

    os.environ.pop("SPARTAN_TPU_DEVICE_DPLOG", None)  # the host path
    n, x_ints, a_ints, y = _dplog_inputs()
    tj = jmerlin.Transcript(b"dplog")
    proof, cx, cy = jdl.DotProductProofLog.prove(
        jsigma.DotProductProofGens(n, b"dplog test"), tj,
        jmerlin.RandomTape(b"tape", seed=31), jdense.from_ints(x_ints), 555,
        jdense.from_ints(a_ints), a_ints, y, 777)
    w = jser.Writer()
    jser._w_dotproduct_log(w, proof)
    return dict(proof=from_bytes(w.getvalue()), cx=from_bytes(cx),
                cy=from_bytes(cy), post=from_ints(tj.challenge_scalar(b"post")))


# tests/test_torch_msm.py


@contextlib.contextmanager
def _fplazy():
    """The TPU row-MSM's lazy field, run eagerly with ``_roll`` as
    ``jnp.roll`` (as ``tests/test_pallas_msm.py`` runs it)."""
    import jax.numpy as jnp

    from spartan_tpu.curve import pallas_msm as pm

    roll = pm._roll
    pm._roll = lambda x, k, axis: jnp.roll(x, k, axis)
    try:
        yield pm, pm._FpLazy(jnp.asarray(pm._CONSTS))
    finally:
        pm._roll = roll


def _blocks(pm, vals):
    """python ints -> the Pallas kernel's (H, W) 16-bit-limb block."""
    import jax.numpy as jnp

    a = np.zeros((pm.H, len(vals)), np.uint32)
    for w, v in enumerate(vals):
        for i in range(16):
            a[i, w] = (v >> (16 * i)) & 0xFFFF
    return jnp.asarray(a)


def _block_ints_mod_p(arr):
    from spartan_tpu.core.field import P25519 as P

    a = np.asarray(arr)
    return [sum(int(a[i, w]) << (16 * i) for i in range(16)) % P
            for w in range(a.shape[1])]


@_recorder("msm-fplazy-ops")
def _msm_fplazy_ops():
    """``_FpLazy.mul``, ``add`` and ``sub`` on 8 pairs, mod p."""
    from test_torch_msm import _lazy_inputs

    with _fplazy() as (pm, fpl):
        ja, jb = (_blocks(pm, v) for v in _lazy_inputs())
        return {op: from_ints(_block_ints_mod_p(getattr(fpl, op)(ja, jb)))
                for op in ("mul", "add", "sub")}


@_recorder("msm-padd")
def _msm_padd():
    """``pallas_msm._padd`` on 3 pairs of points (the last a doubling):
    X, Y, Z, T mod p."""
    from test_torch_msm import _padd_inputs

    p1, p2 = _padd_inputs()
    with _fplazy() as (pm, fpl):
        def blocks(pts):
            return tuple(_blocks(pm, [getattr(p, c) for p in pts])
                         for c in "XYZT")

        return dict(coords=from_ints([_block_ints_mod_p(c) for c in
                                      pm._padd(fpl, blocks(p1), blocks(p2))]))


# tests/test_torch_nizk.py


@_recorder("nizk-jax-verify")
def _nizk_jax_verify():
    """The JAX package's ``NIZK.verify`` of ``tests/golden/nizk_proof.bin``
    at the golden shape: the bytes it accepted and its transcript's next
    challenge (``post``)."""
    from spartan_tpu import api as japi
    from spartan_tpu import serialize as jser
    from spartan_tpu.core.merlin import Transcript

    blob = (TESTS / "golden" / "nizk_proof.bin").read_bytes()
    inst, _, inputs = japi.Instance.produce_synthetic_r1cs(16, 16, 2,
                                                           seed=424242)
    t = Transcript(b"golden_nizk")
    jser.nizk_from_bytes(blob).verify(inst, inputs, t,
                                      japi.NIZKGens(16, 16, 2))
    return dict(proof=from_bytes(blob),
                post=from_ints(t.challenge_scalar(b"post")))


# tests/test_torch_parallel.py


@_recorder("parallel-unshard-{d}", d=2)
@_recorder("parallel-unshard-{d}", d=4)
@_recorder("parallel-unshard-{d}", d=8)
def _parallel_unshard(d):
    """``parallel/mesh.py::unshard_table`` of a (32, 16) table over d
    shards, as a map: entry k of the result came from flat entry
    ``index[k]`` of its argument (a layout, the same for any values)."""
    import jax.numpy as jnp

    from spartan_tpu.parallel import mesh as jmesh

    idx = np.arange(32 * 16, dtype=np.uint32).reshape(32, 16)
    return dict(index=np.asarray(jmesh.unshard_table(jnp.asarray(idx), d)))


# tests/test_torch_device_transcript.py


@_recorder("transcript-keccak")
def _transcript_keccak():
    """``transcript/device.py::keccak_f1600_device`` on one state."""
    import jax.numpy as jnp

    from spartan_tpu.transcript import device as jdt
    from test_torch_device_transcript import _keccak_lanes

    lo, hi = _keccak_lanes()
    jlo, jhi = jdt.keccak_f1600_device(jnp.asarray(lo), jnp.asarray(hi))
    return dict(lo=np.asarray(jlo), hi=np.asarray(jhi))


@_recorder("transcript-compress")
def _transcript_compress():
    """``curve/ristretto.py::compress`` of four points (the port's
    coordinates, carried across): the canonical s as 16-bit limbs."""
    import jax.numpy as jnp

    from spartan_tpu.curve import ristretto as jri
    from spartan_tpu.curve.edwards import PointArray
    from spartan_tpu_torch import interop
    from spartan_tpu_torch.curve import edwards as ed
    from test_torch_device_transcript import _points

    port = ed.from_host(_points()[:4], "cpu")
    jp = PointArray(*(jnp.asarray(interop.fq_to_jax(c)) for c in port))
    return dict(s=np.asarray(jri.compress(jp)))


def record(name: str) -> None:
    np.savez(path(name), **RECORDERS[name]())


def main(names) -> None:
    for name in names or sorted(RECORDERS):
        record(name)
        print(f"wrote {path(name).relative_to(TESTS.parent)}")


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    # the packages, and the test modules' input helpers
    sys.path[:0] = [str(TESTS.parent), str(TESTS)]
    main(sys.argv[1:])
