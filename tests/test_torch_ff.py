"""The port's field layer (``spartan_tpu_torch.ff``) against the JAX
package's python-int field (``spartan_tpu.core.field``) and its limb
layout.

Values include the edge cases 0, 1, q-1, p-1, p and the lazy 2^256 - 1;
everything is exact integer arithmetic, so every comparison is equality.
"""

import ctypes
import random

import jax  # noqa: F401
import numpy as np
import pytest
import torch

from port_limits import *  # noqa: F403  (time limit, no XLA)
from spartan_tpu.core.field import P25519 as P
from spartan_tpu.core.field import Q
from spartan_tpu.ff import fq as jfq
from spartan_tpu.ff import limb as jlimb
from spartan_tpu_torch import interop
from spartan_tpu_torch.ff import fp25519 as fp
from spartan_tpu_torch.ff import fq, limb

R = 1 << 256
M = R - 1
R_INV = pow(R, -1, Q)


def _scalars(seed, n=200):
    rng = random.Random(seed)
    return [0, 1, Q - 1, 2, Q - 2] + [rng.randrange(Q) for _ in range(n)]


def test_limb_pack_roundtrip():
    rng = random.Random(1)
    xs = [0, 1, M, P, Q] + [rng.randrange(R) for _ in range(100)]
    t = limb.ints_to_limbs(xs)
    assert t.dtype == torch.int32 and t.shape == (len(xs), 8)
    assert limb.limbs_to_ints(t) == xs
    assert limb.limbs_to_ints(limb.pack(limb.unpack(t))) == xs
    assert limb.to_int16(limb.unpack(t)) == xs


def test_interop_reinterprets_jax_limbs():
    """The JAX package's (n, 16) 16-bit limbs and the port's (n, 8)
    int32 words are the same bytes."""
    xs = _scalars(2, 50) + [M]
    j = jlimb.ints_to_limbs(xs)  # numpy (n, 16) uint32
    t = interop.fq_from_jax(j)
    assert limb.limbs_to_ints(t) == xs
    np.testing.assert_array_equal(interop.fq_to_jax(t), j)
    # a Montgomery table made by the JAX package's host encoder
    m = interop.fq_from_jax(jfq.encode_ints_mont(xs[:-1]))
    assert fq.decode_to_ints(m) == [x % Q for x in xs[:-1]]


@pytest.mark.parametrize("op", ["mul", "add", "sub"])
def test_fq_binary_ops(op):
    xs, ys = _scalars(3), list(reversed(_scalars(4)))
    a, b = fq.encode_ints(xs), fq.encode_ints(ys)
    ref = {"mul": lambda x, y: x * y, "add": lambda x, y: x + y,
           "sub": lambda x, y: x - y}[op]
    got = fq.decode_to_ints(getattr(fq, op)(a, b))
    assert got == [ref(x, y) % Q for x, y in zip(xs, ys)]


def test_fq_mont_maps():
    xs = _scalars(5)
    c = limb.ints_to_limbs(xs)
    assert limb.limbs_to_ints(fq.to_mont(c)) == [x * R % Q for x in xs]
    assert limb.limbs_to_ints(fq.from_mont(fq.to_mont(c))) == xs
    assert limb.limbs_to_ints(fq.from_mont(c)) == [x * R_INV % Q for x in xs]


def test_fq_sums_and_reduce_wide():
    xs, ys = _scalars(6), _scalars(7)
    a, b = fq.encode_ints(xs), fq.encode_ints(ys)
    assert fq.decode_to_ints(fq.sum_mod(a)[None]) == [sum(xs) % Q]
    assert fq.decode_to_ints(fq.dot_mod(a, b)[None]) == [
        sum(x * y for x, y in zip(xs, ys)) % Q]
    rng = random.Random(8)
    w = [0, (1 << 512) - 1, Q, Q * Q] + [rng.randrange(1 << 512)
                                          for _ in range(60)]
    got = limb.limbs_to_ints(fq.reduce_wide(limb.from_int16(w, n=32)))
    assert got == [x % Q for x in w]


@pytest.mark.parametrize("op", ["mul", "add", "sub", "to_mont",
                                "from_mont", "dot0", "dot1"])
def test_fq_in_pieces(monkeypatch, op):
    """With pieces of 7 elements, the storage-layout operations and the
    dot product along either axis (broadcast, as bound_L and Spark's
    batched evaluation call it) still equal python ints."""
    monkeypatch.setattr(fq, "CHUNK", 7)
    xs, ys = _scalars(11, n=35), _scalars(12, n=35)  # 40 each
    a, b = fq.encode_ints(xs), fq.encode_ints(ys)
    if op in ("dot0", "dot1"):
        M_ = a.reshape(5, 8, 8)  # M_[i][j] = xs[8 i + j]
        if op == "dot0":  # sum_i ys[i] M_[i, j], ys[i] broadcast over j
            got = fq.dot_mod(M_, b[:5, None, :], dim=0)
            want = [sum(ys[i] * xs[8 * i + j] for i in range(5)) % Q
                    for j in range(8)]
        else:  # sum_j M_[i, j] ys[j], ys broadcast over i
            got = fq.dot_mod(M_, b[:8], dim=1)
            want = [sum(xs[8 * i + j] * ys[j] for j in range(8)) % Q
                    for i in range(5)]
        assert fq.decode_to_ints(got) == want
        return
    if op in ("to_mont", "from_mont"):
        c = limb.ints_to_limbs(xs)
        got = limb.limbs_to_ints(getattr(fq, op)(c))
        f = R if op == "to_mont" else R_INV
        assert got == [x * f % Q for x in xs]
        return
    ref = {"mul": lambda x, y: x * y, "add": lambda x, y: x + y,
           "sub": lambda x, y: x - y}[op]
    assert fq.decode_to_ints(getattr(fq, op)(a, b)) == [
        ref(x, y) % Q for x, y in zip(xs, ys)]


@pytest.mark.parametrize("op", ["mul16", "add16", "sub16"])
def test_fp_lazy_ops(op):
    """Lazy mod-p ops keep every limb below 2^16 + 64 and the residue
    exact, for loose inputs up to 2^256 - 1 and chained twice."""
    rng = random.Random(9)
    ps = [0, 1, P - 1, P, M, 19, 38] + [rng.randrange(R) for _ in range(150)]
    qs = [M, M, P - 1, P - 1, M, 0, M] + [rng.randrange(R) for _ in range(150)]
    ref = {"mul16": lambda x, y: x * y, "add16": lambda x, y: x + y,
           "sub16": lambda x, y: x - y}[op]
    f = getattr(fp, op)
    out = f(limb.from_int16(ps), limb.from_int16(qs))
    assert int(out.min()) >= 0 and int(out.max()) < (1 << 16) + 64
    assert [v % P for v in limb.to_int16(out)] == [
        ref(x, y) % P for x, y in zip(ps, qs)]
    out2 = f(out, out)
    assert int(out2.max()) < (1 << 16) + 64
    firsts = [ref(x, y) for x, y in zip(ps, qs)]
    assert limb.to_int16(fp.canonical16(out2)) == [
        ref(v, v) % P for v in firsts]


def test_fp_storage_ops_canonical():
    rng = random.Random(10)
    xs = [0, 1, P - 1] + [rng.randrange(P) for _ in range(50)]
    ys = [P - 1, 0, P - 1] + [rng.randrange(P) for _ in range(50)]
    a, b = fp.encode_ints(xs), fp.encode_ints(ys)
    assert fp.decode_to_ints(fp.mul(a, b)) == [x * y % P for x, y in zip(xs, ys)]
    assert fp.decode_to_ints(fp.add(a, b)) == [(x + y) % P for x, y in zip(xs, ys)]
    assert fp.decode_to_ints(fp.sub(a, b)) == [(x - y) % P for x, y in zip(xs, ys)]
    lazy = limb.ints_to_limbs([M, P, P + 5, 2 * P + 37])
    assert fp.decode_to_ints(fp.reduce_canonical(lazy)) == [
        M % P, 0, 5, 37 % P]


# The wrappers of kernels K7 and K8 (ff/fq.py) on the CPU: the plain
# versions, the same values, no launch counted; and what they refuse.

def _cpu_calls():
    xs, ys = _scalars(16, n=30), _scalars(17, n=30)
    a, b = fq.encode_ints(xs), fq.encode_ints(ys)
    m = a[:32].reshape(4, 8, 8)
    r = fq.mont_limbs(ys[3])
    return {
        "mul": (lambda: fq.mul(a, b), [x * y % Q for x, y in zip(xs, ys)]),
        "add": (lambda: fq.add(a, b), [(x + y) % Q for x, y in zip(xs, ys)]),
        "sub": (lambda: fq.sub(a, b), [(x - y) % Q for x, y in zip(xs, ys)]),
        "neg": (lambda: fq.neg(a), [-x % Q for x in xs]),
        "square": (lambda: fq.square(a), [x * x % Q for x in xs]),
        "scalar": (lambda: fq.mul(r, a), [ys[3] * x % Q for x in xs]),
        "eq_step": (lambda: fq.eq_step(a, r), [
            v for x in xs for v in ((x - x * ys[3]) % Q, x * ys[3] % Q)]),
        "dot_mod": (lambda: fq.dot_mod(m, b[:8], dim=-1), [
            sum(xs[8 * i + j] * ys[j] for j in range(8)) % Q
            for i in range(4)]),
        "sum_mod": (lambda: fq.sum_mod(m, dim=0), [
            sum(xs[8 * i + j] for i in range(4)) % Q for j in range(8)]),
    }


@pytest.mark.parametrize("op", list(_cpu_calls()))
def test_fq_wrappers_take_the_plain_path_on_the_cpu(op):
    fn, want = _cpu_calls()[op]
    before = dict(fq.launches)
    assert fq.decode_to_ints(fn()) == want
    assert dict(fq.launches) == before


@pytest.mark.parametrize("op", ["mul", "add", "sub", "to_mont", "from_mont"])
def test_fq_wrappers_out_view_on_the_cpu(op):
    xs, ys = _scalars(18, n=20), _scalars(19, n=20)
    a, b = fq.encode_ints(xs), fq.encode_ints(ys)
    args = (a,) if op in ("to_mont", "from_mont") else (a, b)
    z = torch.zeros((len(xs) + 5, 8), dtype=torch.int32)
    got = getattr(fq, op)(*args, out=z[2:2 + len(xs)])
    assert got.data_ptr() == z[2].data_ptr()
    assert torch.equal(z[2:2 + len(xs)],
                       getattr(fq, op + "_plain")(*args))
    assert not z[:2].any() and not z[2 + len(xs):].any()


def _bad_calls():
    a = fq.encode_ints(_scalars(20, n=5))
    return {
        "int64": lambda: fq.mul(a.to(torch.int64), a),
        "width": lambda: fq.add(a, a.reshape(-1, 16)[:, :8].repeat(1, 2)),
        "scalar_dim": lambda: fq.sub(a, torch.tensor(3, dtype=torch.int32)),
        "not_tensor": lambda: fq.mul(a, 3),
        "devices": lambda: fq.mul(a, a.to("meta")),
        "meta": lambda: fq.from_mont(a.to("meta")),
        "out_shape": lambda: fq.mul(a, a, out=torch.empty_like(a[:-1])),
        "out_strided": lambda: fq.add(a, a, out=torch.empty(
            (a.shape[0], 16), dtype=torch.int32)[:, :8]),
        "to_mont_dtype": lambda: fq.to_mont(a.to(torch.int16)),
        "eq_step_point": lambda: fq.eq_step(a, a[:2]),
        "eq_step_table": lambda: fq.eq_step(a[None], a[0]),
        "dot_dim": lambda: fq.dot_mod(a, a, dim=1),
        "sum_dim": lambda: fq.sum_mod(a, dim=-2),
        "sum_elem": lambda: fq.sum_mod(a[0]),
    }


@pytest.mark.parametrize("case", list(_bad_calls()))
def test_fq_wrappers_raise_on_what_they_do_not_take(case):
    before = dict(fq.launches)
    with pytest.raises(ValueError):
        _bad_calls()[case]()
    assert dict(fq.launches) == before


def _walk(x, parts, strides):
    """Word offsets of x's elements (row-major over its element dims)
    from the grouped strides, as the kernels compute them."""
    lens = x.shape[:-1]
    offs = []
    for idx in np.ndindex(*lens):
        off = 0
        for (lo, hi), s in zip(parts, strides):
            flat = 0
            for d in range(lo, hi):
                flat = flat * lens[d] + idx[d]
            off += flat * s
        offs.append(off)
    return offs


@pytest.mark.parametrize("view", ["table", "scalar", "rows", "halves",
                                  "column", "transposed", "permuted"])
def test_fq_kernel_strides_walk_the_view(view):
    """The strides the wrappers hand K7 and K8 address each element of
    the view where torch does, or are None (the wrapper then copies the
    view to a contiguous table)."""
    base = torch.zeros((4, 6, 8), dtype=torch.int32)
    x = {"table": base, "scalar": base[1, 2].expand(4, 6, 8),
         "rows": base[:, :1].expand(4, 6, 8), "halves": base[:, 3:],
         "column": base[:, 0], "transposed": base.transpose(0, 1),
         "permuted": base.reshape(2, 3, 4, 8).permute(0, 2, 1, 3)}[view]
    want = [(x[idx].data_ptr() - base.data_ptr()) // 4
            for idx in np.ndindex(*x.shape[:-1])]
    nd = x.dim() - 1
    two = [((0, 0), (0, nd))] + [((0, p), (p, nd)) for p in range(1, nd)]
    three = [((0, p), (p, p + 1), (p + 1, nd)) for p in range(nd)]
    walked = []
    for parts in two + three:
        st = fq._strides(x, parts)
        if st is not None:
            walked.append(len(parts))
            assert [o + (x.data_ptr() - base.data_ptr()) // 4
                    for o in _walk(x, parts, st)] == want
    # K7's two levels walk all but the permuted view; K8's three, all
    assert (2 in walked) == (view != "permuted") and 3 in walked


class _EmulatedKernels:
    """K7's and K8's C entries emulated on host memory with python ints,
    addressing each element as the kernels do (``fq_elementwise.cu``'s
    ``element``, ``fq_reduce.cu``'s o, i, k strides), so the CPU tests
    drive the wrappers' strides, splits and copies through a launch."""

    @staticmethod
    def _get(addr):
        return int.from_bytes(ctypes.string_at(addr, 32), "little")

    @staticmethod
    def _put(addr, v):
        ctypes.memmove(addr, v.to_bytes(32, "little"), 32)

    def fq_elementwise_launch(self, a, a_rs, a_cs, b, b_rs, b_cs, out, n,
                              cols, mode, stream):
        def elem(p, rs, cs, i):
            r, c = divmod(i, cols)
            return self._get(p + 4 * (r * rs + c * cs))

        for i in range(n):
            x = elem(a, a_rs, a_cs, i)
            y = elem(b, b_rs, b_cs, i)
            if mode == 5:  # EQ
                hi = x * y * R_INV % Q
                self._put(out + 64 * i, (x - hi) % Q)
                self._put(out + 64 * i + 32, hi)
                continue
            v = [x * R, x * y * R_INV, x + y, x - y, x * R_INV][mode] % Q
            self._put(out + 32 * i, v)
        return 0

    def fq_reduce_launch(self, a, so, si, sk, O, I, K, w, ws, out, kt_log,
                         splits, partial, ticket, stream):
        for o in range(O):
            for k in range(K):
                acc = 0
                for i in range(I):
                    x = self._get(a + 4 * (o * so + i * si + k * sk))
                    acc += (x * self._get(w + 4 * i * ws) * R_INV % Q
                            if w else x)
                self._put(out + 32 * (o * K + k), acc % Q)
        return 0


@pytest.fixture
def emulated(monkeypatch):
    monkeypatch.setattr(fq._build, "load", lambda name, declare:
                        _EmulatedKernels())
    monkeypatch.setattr(fq._build, "stream_handle", lambda dev: 0)
    monkeypatch.setattr(fq, "_sm_count", lambda dev: 4)


def _table(shape, seed):
    n = int(np.prod(shape))
    return fq.encode_ints(_scalars(seed, n)[:n]).reshape(*shape, 8)


@pytest.mark.parametrize("case", ["tables", "scalar_b", "scalar_a", "rows",
                                  "halves", "column", "permuted", "to_mont",
                                  "from_mont", "eq"])
def test_fq_k7_wrapper_through_an_emulated_launch(emulated, case):
    """``fq._k7`` hands the kernel strides under which it reads each
    operand's elements in place (or a copy, for the permuted view):
    equal to the plain versions, one launch counted."""
    a, b = _table((4, 6), 30), _table((4, 6), 31)
    p = _table((2, 3, 4), 32).permute(0, 2, 1, 3)  # (2, 4, 3), no 2 levels
    mode, xs = {
        "tables": ("mul", [a, b]), "scalar_b": ("sub", [a, b[1, 2]]),
        "scalar_a": ("sub", [b[1, 2], a]), "rows": ("add", [a, b[:, :1]]),
        "halves": ("mul", [a[:, :3], a[:, 3:]]),
        "column": ("add", [a[:, 0], b[:, 5]]),
        "permuted": ("mul", [p, _table((2, 4, 3), 33)]),
        "to_mont": ("to_mont", [a[:, 1:]]), "from_mont": ("from_mont", [a]),
        "eq": ("eq", [a.reshape(-1, 8), b[2, 3]])}[case]
    shape = torch.broadcast_shapes(*(x.shape for x in xs))
    before = dict(fq.launches)
    got = fq._k7(mode, xs, shape, None)
    plain = getattr(fq, "eq_step_plain" if mode == "eq" else mode + "_plain")
    assert torch.equal(got, plain(*xs))
    n = int(np.prod(shape[:-1]))
    assert fq.launches[mode, n] == before.get((mode, n), 0) + 1


@pytest.mark.parametrize("case", ["evaluate", "batched", "bound_L", "three",
                                  "sum", "sum_view", "permuted", "full"])
def test_fq_k8_wrapper_through_an_emulated_launch(emulated, case):
    """``fq.dot_mod``'s and ``fq.sum_mod``'s card path (``_k8``, with
    the operand that varies along ``dim`` alone as the weight), each
    table read through its (o, i, k) strides: equal to the plain
    versions."""
    t = _table((3, 5, 4), 40)
    cases = {
        "evaluate": ("dot", t.reshape(-1, 8), _table((60,), 41), 0),
        "batched": ("dot", t.reshape(3, 20, 8), _table((20,), 42), 1),
        "bound_L": ("dot", t.reshape(6, 10, 8), _table((6, 1), 43), 0),
        "three": ("dot", t, _table((5, 1), 44), 1),
        "sum": ("sum", t, None, 1),
        "sum_view": ("sum", t[:, 1:4], None, 0),
        "permuted": ("dot", t.permute(1, 0, 2, 3), _table((3, 1), 45), 1),
        "full": ("dot", t, _table((3, 5, 4), 46), 1)}
    mode, x, y, dim = cases[case]
    before = dict(fq.launches)
    if y is None:
        got = fq._k8("sum", x, None, x.shape, dim)
        want = fq.sum_mod_plain(x, dim)
    else:
        shape = torch.broadcast_shapes(x.shape, y.shape)
        if case == "full":  # neither is a weight: K7's products, K8's sum
            got = fq._k8("sum", fq._k7("mul", [x, y], shape, None), None,
                         shape, dim)
        else:
            got = fq._k8("dot", x, y, shape, dim)
        want = fq.dot_mod_plain(x, y, dim)
    assert torch.equal(got, want)
    counted = {k[0] for k, v in fq.launches.items() if v != before.get(k, 0)}
    assert counted == ({"mul", "sum"} if case == "full" else {mode})
