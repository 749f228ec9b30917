"""The port's multi-device prover (``spartan_tpu_torch/parallel/``) on
meshes of CPU devices.

* ``ShardedSumcheckTables`` for each comb of ``_combs.NTABLES`` and
  ``ShardedProductLayerTables`` at (B, n) = (3, 2^6), over D = 2, 4 and
  8 shards: every round's evals and the final scalars equal B2's
  unsharded chain (its plain version here), and sharded rounds ran.
* ``shard_table``/``unshard_table`` round-trip, and the shards laid
  end to end are what the JAX package's ``unshard_table`` takes (its
  layout map recorded in ``tests/golden/port/parallel-unshard-*.npz``).
* ``msm_rows_blocked`` and ``sharded_msm`` give the compressed points of
  the one-launch MSMs; ``psum_mod_q`` and ``evals_to_ints`` sum partial
  evals mod q.
* Under ``Mesh(["cpu"] * 2)`` and ``Mesh(["cpu"] * 4)`` the golden NIZK
  and SNARK come out byte for byte as ``tests/golden/``, with sharded
  rounds and row blocks counted.
* ``get_mesh()`` treats a one-device mesh as none, and the device-prover
  gates are off under a mesh.

No JAX prove or compile.
"""

import os

import jax  # noqa: F401  (imported first in every port test file)
import numpy as np
import pytest
import torch

from golden.port.record import load
from port_limits import *  # noqa: F403  (time limit, no XLA)
from spartan_tpu_torch import interop
from spartan_tpu_torch import serialize as ser
from spartan_tpu_torch.api import NIZK, SNARK, Instance, NIZKGens, SNARKGens
from spartan_tpu_torch.commitments import MultiCommitGens
from spartan_tpu_torch.core import edwards as hed
from spartan_tpu_torch.core import ristretto as hri
from spartan_tpu_torch.core.field import Q
from spartan_tpu_torch.core.merlin import Transcript
from spartan_tpu_torch.curve import edwards as ed
from spartan_tpu_torch.curve import msm
from spartan_tpu_torch.curve import ristretto as dri
from spartan_tpu_torch.ff import fq, limb
from spartan_tpu_torch.ff.round_kernel import fold_evals
from spartan_tpu_torch.parallel import context as pctx
from spartan_tpu_torch.parallel import mesh as pmesh
from spartan_tpu_torch.protocols import _combs
from spartan_tpu_torch.protocols import sumcheck

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
SHAPE = (16, 16, 2)


def _golden(name):
    with open(os.path.join(GOLDEN, name), "rb") as f:
        return f.read()


def _tables(seed, count, shape):
    """``count`` Montgomery tables of ``shape`` entries, made from
    ``seed``."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    return [fq.encode_ints([int.from_bytes(rng.bytes(32), "little") % Q
                            for _ in range(n)]).reshape(*shape, 8)
            for _ in range(count)]


def _rounds(tabs, log_n, tables_now, rs):
    """Every round's evals of ``tabs`` (a sharded manager) and of B2's
    unsharded chain on ``tables_now``, and both final scalars."""
    got = [pmesh.evals_to_ints(tabs.evals())]
    tables_now, ev = fold_evals(tables_now, None, "evals")
    want = [fq.decode_to_ints(ev)]
    for j, r in enumerate(rs[:log_n]):
        mode = "fold_evals" if j + 1 < log_n else "fold"
        ev = tabs.round(r, mode)
        tables_now, want_ev = fold_evals(tables_now, r, mode)
        if mode != "fold":
            got.append(pmesh.evals_to_ints(ev))
            want.append(fq.decode_to_ints(want_ev))
    final = torch.stack([T[..., 0, :] for T in tables_now])
    return got, want, fq.decode_to_ints(tabs.final_scalars()), \
        fq.decode_to_ints(final)


RS = [(7 ** (k + 40)) % Q for k in range(8)]


@pytest.mark.parametrize("d", [2, 4, 8])
@pytest.mark.parametrize("which", sorted(_combs.NTABLES))
def test_sharded_sumcheck_tables_equal_unsharded(which, d):
    log_n = 6
    # cubic_prod's three tables as B2 takes them: one instance, (1, n, 8)
    shape = (1, 1 << log_n) if which == "cubic_prod" else (1 << log_n,)
    tables = _tables(11, _combs.NTABLES[which], shape)
    mesh = pmesh.Mesh(["cpu"] * d)
    tabs = pmesh.ShardedSumcheckTables(mesh, tables, which)
    got, want, got_final, want_final = _rounds(tabs, log_n, tables, RS)
    assert got == want
    assert got_final == want_final
    assert sum(mesh.sharded_rounds.values()) > 0
    assert {k for k, _ in mesh.sharded_rounds} == {"sumcheck"}


@pytest.mark.parametrize("d", [2, 4, 8])
def test_sharded_product_layer_equal_unsharded(d):
    log_n = 6
    A, Bt, C = _tables(12, 3, (3, 1 << log_n))
    mesh = pmesh.Mesh(["cpu"] * d)
    tabs = pmesh.ShardedProductLayerTables(mesh, A, Bt, C)
    got, want, got_final, want_final = _rounds(tabs, log_n, [A, Bt, C], RS)
    assert got == want
    assert got_final == want_final
    # the first sharded round runs at the shards' full size
    assert mesh.sharded_rounds["layer", (1 << log_n) // d] > 0


def test_product_layer_step_is_fold_evals():
    A, Bt, C = _tables(13, 3, (2, 32))
    mesh = pmesh.Mesh(["cpu"] * 2)
    a = pmesh.ShardedProductLayerTables(mesh, A, Bt, C)
    b = pmesh.ShardedProductLayerTables(mesh, A, Bt, C)
    a.evals(), b.evals()
    assert all(torch.equal(x, y) for x, y in
               zip(a.step(RS[0]), b.fold_evals(RS[0])))


def test_partial_sums_mod_q():
    xs = [_tables(16 + k, 1, (3, 2))[0] for k in range(4)]
    ints = [fq.decode_to_ints(x) for x in xs]
    want = [sum(col) % Q for col in zip(*ints)]
    assert fq.decode_to_ints(pmesh.psum_mod_q(xs, "cpu")) == want
    assert pmesh.evals_to_ints(xs) == want
    assert pmesh.evals_to_ints(xs[:1]) == ints[0]


def test_final_scalars_only_after_unshard():
    tables = _tables(14, 2, (16,))
    tabs = pmesh.ShardedSumcheckTables(pmesh.Mesh(["cpu"] * 2), tables,
                                       "quad")
    tabs.evals()
    with pytest.raises(RuntimeError):
        tabs.final_scalars()


def test_wrong_table_count_raises():
    with pytest.raises(ValueError):
        pmesh.ShardedSumcheckTables(pmesh.Mesh(["cpu"] * 2),
                                    _tables(15, 3, (16,)), "cubic")


@pytest.mark.parametrize("d", [2, 4, 8])
def test_shard_unshard_roundtrip_and_jax_layout(d):
    rng = np.random.default_rng(20)
    n = 32
    jtab = rng.integers(0, 1 << 16, size=(n, 16), dtype=np.uint32)
    tab = interop.fq_from_jax(jtab)
    shards = pmesh.shard_table(tab, pmesh.Mesh(["cpu"] * d))
    assert [s.shape[0] for s in shards] == [n // d] * d
    assert torch.equal(pmesh.unshard_table(shards, "cpu"), tab)
    # the shards end to end are JAX's shard-major layout
    flat = interop.fq_to_jax(torch.cat(shards))
    jax_unshard = load(f"parallel-unshard-{d}")["index"]
    assert np.array_equal(flat.reshape(-1)[jax_unshard], jtab)
    # batched (B, n, 8): the hypercube axis n shards
    btab = torch.stack([tab, tab.flip(0)])
    bshards = pmesh.shard_table(btab, pmesh.Mesh(["cpu"] * d))
    assert torch.equal(bshards[1][0], shards[1])
    assert torch.equal(pmesh.unshard_table(bshards, "cpu"), btab)


def _points(n, tag):
    import hashlib

    return [hri.from_uniform_bytes(hashlib.sha512(b"%s%d" % (tag, i))
                                   .digest()) for i in range(n)]


@pytest.mark.parametrize("d", [2, 4, 3])
def test_msm_rows_blocked_equals_msm_rows(d):
    L, R = 4, 8
    gens = MultiCommitGens(R, b"test_torch_parallel")
    rng = np.random.default_rng(21)
    s = limb.ints_to_limbs([int(x) for x in rng.integers(
        0, 1 << 62, size=L * R)]).reshape(L, R, 8)
    mesh = pmesh.Mesh(["cpu"] * d)
    got = pmesh.msm_rows_blocked(s, gens, mesh)
    want = msm.msm_rows(s, gens)
    assert dri.compress_to_bytes(got) == dri.compress_to_bytes(want)
    # 3 shards do not divide 4 rows: one launch, as the JAX package
    blocks = {2: {("row_msm", 2, R): 2}, 4: {("row_msm", 1, R): 4}, 3: {}}
    assert dict(mesh.msm_blocks) == blocks[d]


def test_sharded_msm_equals_host_msm():
    n, d = 8, 4
    pts = _points(n, b"smsm")
    rng = np.random.default_rng(22)
    ks = [int(x) for x in rng.integers(1, 1 << 62, size=n)]
    mesh = pmesh.Mesh(["cpu"] * d)
    out = pmesh.sharded_msm(mesh)(limb.ints_to_limbs(ks),
                                  ed.stack(ed.from_host(pts)))
    assert out.shape == (1, 4, 8)
    got = ed.to_host(ed.unstack(out))[0]
    assert hri.encode(got) == hri.encode(hed.msm(ks, pts))
    assert dict(mesh.msm_blocks) == {("point_msm", n // d): d}


@pytest.fixture(scope="module")
def golden_instance():
    inst, vars_a, inputs_a = Instance.produce_synthetic_r1cs(
        *SHAPE, seed=424242, device="cpu")
    return inst, vars_a, inputs_a


@pytest.mark.parametrize("d", [2, 4])
def test_golden_nizk_under_a_mesh(golden_instance, d):
    inst, vars_a, inputs_a = golden_instance
    gens = NIZKGens(*SHAPE)
    mesh = pmesh.Mesh(["cpu"] * d)
    with pctx.use_mesh(mesh):
        nizk = NIZK.prove(inst, vars_a, inputs_a, gens,
                          Transcript(b"golden_nizk"), _tape_seed=31337)
    assert ser.nizk_to_bytes(nizk) == _golden("nizk_proof.bin")
    # phase one's 16 entries fold once sharded at D = 4 (16 >= 4 * 4)
    assert mesh.sharded_rounds["sumcheck", 16 // d] >= 2
    assert sum(mesh.msm_blocks.values()) == d
    nizk.verify(inst, inputs_a, Transcript(b"golden_nizk"), gens)


@pytest.mark.parametrize("d", [2, 4])
def test_golden_snark_under_a_mesh(golden_instance, d):
    inst, vars_a, inputs_a = golden_instance
    nnz = max(m.get_num_nz_entries()
              for m in (inst.inst.A, inst.inst.B, inst.inst.C))
    gens = SNARKGens(*SHAPE, nnz)
    mesh = pmesh.Mesh(["cpu"] * d)
    with pctx.use_mesh(mesh):
        comm, decomm = SNARK.encode(inst, gens)
        snark = SNARK.prove(inst, comm, decomm, vars_a, inputs_a, gens,
                            Transcript(b"golden_snark"), _tape_seed=31337)
    assert ser.commitment_to_bytes(comm) == _golden("snark_commitment.bin")
    assert ser.snark_to_bytes(snark) == _golden("snark_proof.bin")
    kinds = {k for k, _ in mesh.sharded_rounds}
    assert kinds == {"sumcheck", "layer"}
    assert mesh.msm_blocks


def test_one_device_mesh_is_none():
    assert pctx.get_mesh() is None
    with pctx.use_mesh(pmesh.Mesh(["cpu"])):
        assert pctx.get_mesh() is None
    mesh = pmesh.Mesh(["cpu"] * 2)
    with pctx.use_mesh(mesh):
        assert pctx.get_mesh() is mesh
    assert pctx.get_mesh() is None


def test_device_prover_gates_off_under_a_mesh(monkeypatch):
    monkeypatch.setenv("SPARTAN_TPU_DEVICE_PROVER", "1")
    monkeypatch.setenv("SPARTAN_TPU_DEVICE_NONZK", "1")
    assert sumcheck._use_device_prover() and sumcheck._use_device_nonzk()
    with pctx.use_mesh(pmesh.Mesh(["cpu"] * 2)):
        assert not sumcheck._use_device_prover()
        assert not sumcheck._use_device_nonzk()


def test_make_mesh_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        pmesh.make_mesh()
