"""Device-resident prover loops (the JAX package's
``protocols/device_prover.py``): a ZK sum-check phase, the whole tree
of Spark's batched product-layer proofs, or a dot-product-log proof runs
start to finish on the device with no fetch per round, and the proof
comes back in ONE packed fetch at the end.

The Fiat-Shamir transcript lives on the device (``transcript.device``),
so a round's challenge never leaves it: kernel B2 (``ff.round_kernel``)
folds by a challenge it reads through a pointer, and so does kernel K6
(``ff.bullet_kernel``) in a bullet round.  In a ZK round the Pedersen
commitments are launches of kernel K5 (``curve.point_msm``, constant
time in the tape secrets they commit) on the phase's bases, compressed
on the device by kernel K4 (``curve.ristretto.compress``) and absorbed
by the device transcript (kernel K3).  The scalar glue of a ZK round
(the round polynomial, the sigma proof's responses) is plain limb ops on
the device; a bullet round's is K6.

Byte-exact with the host path: the same transcript schedule
(sumcheck.rs:427-776, nizk/mod.rs:292-405, product_tree.rs:258-382) and
the same RandomTape draws, made up front in the reference order
(blinds_poly, blinds_evals, then d_vec, r_delta, r_beta a round).  The
JAX package's padded live-prefix layout answered the TPU's compile
costs and is not ported: tables halve as on the host path.

Turned on by ``SPARTAN_TPU_DEVICE_PROVER=1`` (ZK phases, product
layers and dot-product-log proofs) or ``SPARTAN_TPU_DEVICE_NONZK=1``
(product layers only); see ``protocols/sumcheck.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..commitments import commit_scalar
from ..core import ristretto as hri
from ..core.field import Q
from ..curve import edwards as ed
from ..curve.point_msm import point_msm
from ..curve.ristretto import compress
from ..ff import fq, limb
from ..ff.bullet_kernel import bullet_step
from ..ff.round_kernel import fold_evals
from ..transcript.device import DeviceTranscript, scalar_to_bytes32
from ..utils import rt
from .bullet import BulletReductionProof, round_commit, round_fold

_INV2 = pow(2, -1, Q)
_INV6 = pow(6, -1, Q)


def _c16(x: int, device) -> torch.Tensor:
    """Montgomery constant x in the (16,) compute layout (cached per
    device by ``limb.const16``: uploaded once a process)."""
    return limb.const16(x % Q * fq.R % Q, device)


# ---------------------------------------------------------------------------
# round polynomials on the device (compute layout (..., 16))
# ---------------------------------------------------------------------------

def unipoly_from_evals(evals: list, claim: torch.Tensor) -> torch.Tensor:
    """UniPoly.from_evals (unipoly.rs:22-110) on the device.  evals:
    [e0, e2] (quad) or [e0, e2, e3] (cubic), each (16,); e1 = claim - e0.
    Returns the coefficients (deg+1, 16), low to high."""
    dev = claim.device
    add, sub, mul = fq.add16, fq.sub16, fq.mul16
    e0 = evals[0]
    e1 = sub(claim, e0)
    if len(evals) == 2:
        e2 = evals[1]
        a = mul(_c16(_INV2, dev), add(sub(e2, add(e1, e1)), e0))
        b = sub(sub(e1, e0), a)
        return torch.stack([e0, b, a])
    e2, e3 = evals[1], evals[2]
    # independent products side by side (one mul16 a line)
    k3, k4, k5 = mul(torch.stack([_c16(3, dev), _c16(4, dev), _c16(5, dev)]),
                     torch.stack([sub(e1, e2), e2, e1]))
    t3 = add(k3, sub(e3, e0))
    tb = sub(add(add(e0, e0), k4), add(k5, e3))
    a, b = mul(torch.stack([_c16(_INV6, dev), _c16(_INV2, dev)]),
               torch.stack([t3, tb]))
    c = sub(sub(sub(e1, e0), a), b)
    return torch.stack([e0, c, b, a])


def unipoly_evaluate(coeffs: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Horner from the top; coeffs (k, 16), r (16,)."""
    acc = coeffs[-1]
    for i in range(coeffs.shape[0] - 2, -1, -1):
        acc = fq.add16(coeffs[i], fq.mul16(r, acc))
    return acc


def unipoly_append(t: DeviceTranscript, label: bytes,
                   coeffs: torch.Tensor) -> None:
    """UniPoly::append_to_transcript (unipoly.rs:113-121); coeffs (k, 16)
    Montgomery, their bytes in one conversion."""
    rows = scalar_to_bytes32(limb.pack(coeffs))
    t.append_message(label, b"UniPoly_begin")
    for i in range(rows.shape[0]):
        t.append_message(b"coeff", rows[i])
    t.append_message(label, b"UniPoly_end")


def _eq_table_dev(rand: list, device) -> torch.Tensor:
    """EqPolynomial::evals over device challenges ``rand`` ((8,)
    Montgomery each; rand[0] pairs with the most significant index bit):
    (2^len(rand), 8)."""
    table = _c16(1, device)[None]
    for rj in rand:
        hi = fq.mul16(table, limb.unpack(rj))
        lo = fq.sub16(table, hi)
        table = torch.stack([lo, hi], dim=1).reshape(-1, limb.NLIMBS)
    return limb.pack(table)


# ---------------------------------------------------------------------------
# one upload, one fetch
# ---------------------------------------------------------------------------

def _upload(parts: list[np.ndarray], device) -> list[torch.Tensor]:
    """Host int32 arrays -> device tensors of the same shapes, in one
    copy.  Each part starts on a 32-byte boundary (the kernels load 16
    bytes at a time)."""
    offs, off = [], 0
    for p in parts:
        offs.append(off)
        off += -(-p.size // 8) * 8
    flat = np.zeros(off, dtype="<i4")
    for p, o in zip(parts, offs):
        flat[o:o + p.size] = p.reshape(-1)
    buf = torch.from_numpy(flat).to(device)
    return [buf[o:o + p.size].view(p.shape) for p, o in zip(parts, offs)]


class _Reader:
    """Walks the words of one packed fetch: Montgomery scalars and raw
    32-byte strings, 8 words each."""

    def __init__(self, flat: np.ndarray):
        self.raw = flat.astype("<i4").tobytes()
        self.off = 0

    def _take(self, k: int) -> bytes:
        b = self.raw[self.off:self.off + 32 * k]
        self.off += 32 * k
        return b

    def scalars(self, k: int) -> list[int]:
        b = self._take(k)
        return [int.from_bytes(b[32 * i:32 * i + 32], "little") * fq.R_INV % Q
                for i in range(k)]

    def bytes32(self) -> bytes:
        return self._take(1)


def _fetch(tensors: list[torch.Tensor], t: DeviceTranscript, transcript
           ) -> _Reader:
    """Every tensor (int32, 8 words a scalar or point) and the device
    transcript's state in ONE device->host fetch; the state goes into
    the host ``transcript``.  Returns a reader over the tensors."""
    flat = rt.fetch(torch.cat([x.reshape(-1) for x in tensors]
                              + [t.state_words()]))
    t.write_host(transcript, flat[-50:].astype("<i4").tobytes())
    return _Reader(flat[:-50])


# ---------------------------------------------------------------------------
# ZK sum-check phase
# ---------------------------------------------------------------------------

def _commit_rows(rows16: torch.Tensor, bases: torch.Tensor) -> torch.Tensor:
    """Pedersen commitments of (L, k, 16) Montgomery rows against the
    phase's k bases ((k, 4, 8) points): one K5 launch, a group a row,
    then one K4 launch -> (L, 8) int32 (the 32-byte encodings).  The
    rows hold tape secrets (blinds, d, r_delta, r_beta); K5 is constant
    time in them, as the host path's ladder (``core.edwards.msm_ct``)."""
    L, k = rows16.shape[:2]
    scalars = limb.pack(fq.redc16(rows16)).view(L * k, limb.NWORDS)
    return compress(ed.unstack(point_msm(
        bases.repeat(L, 1, 1), scalars, tuple(range(0, L * k + 1, k)))))


def _as_bytes(enc: torch.Tensor) -> torch.Tensor:
    return enc.view(torch.uint8)


def zk_sumcheck_phase_device(
        claim: int, blind_claim: int, num_rounds: int, tables: list,
        which: str, gens_1, gens_n, transcript, tape):
    """Device replacement for ZKSumcheckInstanceProof._prove_rounds: the
    same arguments and results (proof, r, final claims, last blind), the
    host ``transcript`` advanced to the same final state."""
    from .sigma import DotProductProof
    from .sumcheck import ZKSumcheckInstanceProof

    deg = 3 if which == "cubic" else 2
    assert gens_n.n == deg + 1 and gens_1.n == 1
    dev = tables[0].device
    k = num_rounds

    # RandomTape draws, reference order
    blinds_poly = tape.random_vector(b"blinds_poly", k)
    blinds_evals = tape.random_vector(b"blinds_evals", k)
    draws = []
    for _ in range(k):
        d_vec = tape.random_vector(b"d_vec", deg + 1)
        r_delta = tape.random_scalar(b"r_delta")
        r_beta = tape.random_scalar(b"r_beta")
        draws += d_vec + [r_delta, r_beta]
    claim %= Q
    comm_claim = hri.encode(commit_scalar(claim, blind_claim, gens_1))

    # one upload: scalars, the claim's commitment, the transcript state
    # and the phase's bases [G_0..G_deg, h_n, g_1, h_1] (the two
    # generator families have distinct blinding generators)
    bases = list(gens_n.G[:deg + 1]) + [gens_n.h, gens_1.G[0], gens_1.h]
    st_bytes, pos, pos_begin, flags = DeviceTranscript.host_state(transcript)
    (scal, comm0, state, bases) = _upload([
        fq.encode_ints([claim, blind_claim] + blinds_poly + blinds_evals
                       + draws + [2] + [1] * deg).numpy(),
        np.frombuffer(comm_claim, dtype="<i4"),
        np.frombuffer(st_bytes, dtype="<i4"),
        ed.stack(ed.from_host(bases)).numpy()], dev)
    scal = limb.unpack(scal.view(-1, limb.NWORDS))
    claim_j, blind_sc = scal[0], scal[1]
    bp, be = scal[2:2 + k], scal[2 + k:2 + 2 * k]
    dr = scal[2 + 2 * k:2 + 2 * k + k * (deg + 3)].view(k, deg + 3,
                                                        limb.NLIMBS)
    a_sc = scal[2 + 2 * k + k * (deg + 3):]
    comm_claim_j = _as_bytes(comm0)
    t = DeviceTranscript(None, _state=state.view(torch.uint8), _pos=pos,
                         _pos_begin=pos_begin, _flags=flags)
    zero = torch.zeros(limb.NLIMBS, dtype=torch.int64, device=dev)
    pad2 = zero.expand(2, limb.NLIMBS)

    def pair(x, y):  # a row that commits x * g_1 + y * h_1
        return torch.cat([zero.expand(deg + 2, limb.NLIMBS), x[None],
                          y[None]])

    def poly_rows(coeffs, j):
        """comm_poly = coeffs . G + blind_poly h_n and delta = d . G +
        r_delta h_n of round j."""
        return [torch.cat([coeffs, bp[j][None], pad2]),
                torch.cat([dr[j, :deg + 2], pad2])]

    def round_poly(ev, claim):
        return unipoly_from_evals(list(limb.unpack(ev)[:deg]), claim)

    # A round's commitments in two K5 launches: comm_eval with the next
    # round's comm_poly and delta (both need only this round's challenge),
    # then Cy with beta (they need the combining weights)
    add, sub, mul = fq.add16, fq.sub16, fq.mul16
    out = []
    tabs, ev = fold_evals(tables, None, "evals")
    coeffs = round_poly(ev, claim_j)
    comm_poly, delta = _commit_rows(torch.stack(poly_rows(coeffs, 0)),
                                    bases)
    for j in range(k):
        t.append_point(b"comm_poly", _as_bytes(comm_poly))
        r_st = t.challenge_scalar(b"challenge_nextround")
        mode = "fold_evals" if j + 1 < k else "fold"
        tabs, ev = fold_evals(tabs, r_st, mode)
        r = limb.unpack(r_st)
        eval_r = unipoly_evaluate(coeffs, r)
        rows = [pair(eval_r, be[j])]
        if j + 1 < k:
            coeffs_next = round_poly(ev, eval_r)
            rows += poly_rows(coeffs_next, j + 1)
        enc = _commit_rows(torch.stack(rows), bases)
        comm_eval = enc[0]
        t.append_point(b"comm_claim_per_round", comm_claim_j)
        t.append_point(b"comm_eval", _as_bytes(comm_eval))
        w0, w1 = (limb.unpack(w) for w in
                  t.challenge_vector(b"combine_two_claims_to_one", 2))

        # independent products side by side: one mul16 each line
        prods = mul(torch.stack([claim_j, eval_r, blind_sc, be[j]]),
                    torch.stack([w0, w1, w0, w1]))
        target, blind = add(prods[0::2], prods[1::2])
        pows = [_c16(1, dev)]
        for _ in range(deg):
            pows.append(mul(pows[-1], r))
        prods = mul(torch.cat([a_sc, torch.stack(pows)]),
                    torch.stack([w0, w1]).repeat_interleave(deg + 1, 0))
        a = add(prods[:deg + 1], prods[deg + 1:])

        # DotProductProof.prove (nizk/mod.rs:292-356); Cx is comm_poly
        d_vec, r_beta = dr[j, :deg + 1], dr[j, deg + 2]
        t.append_protocol_name(DotProductProof.PROTOCOL)
        t.append_point(b"Cx", _as_bytes(comm_poly))
        dotp = fq.sum16(mul(a, d_vec))
        cy, beta = _commit_rows(torch.stack([pair(target, blind),
                                             pair(dotp, r_beta)]), bases)
        t.append_point(b"Cy", _as_bytes(cy))
        t.append_scalar_vector(b"a", limb.pack(a))
        t.append_point(b"delta", _as_bytes(delta))
        t.append_point(b"beta", _as_bytes(beta))
        c = limb.unpack(t.challenge_scalar(b"c"))
        # z = c coeffs + d_vec, z_delta = c blind_poly + r_delta, z_beta
        # = c blind + r_beta: dr[j] is (d_vec, r_delta, r_beta)
        zs = add(mul(torch.cat([coeffs, bp[j][None], blind[None]]), c),
                 dr[j])

        out += [comm_poly, comm_eval, delta, beta, limb.pack(zs), r_st]
        claim_j, comm_claim_j = eval_r, _as_bytes(comm_eval)
        blind_sc = be[j]
        if j + 1 < k:
            coeffs, comm_poly, delta = coeffs_next, enc[1], enc[2]

    rd = _fetch(out + [x[0] for x in tabs], t, transcript)
    comm_polys, comm_evals, proofs, r_ints = [], [], [], []
    for j in range(k):
        comm_polys.append(rd.bytes32())
        comm_evals.append(rd.bytes32())
        delta, beta = rd.bytes32(), rd.bytes32()
        zs = rd.scalars(deg + 3)
        proofs.append(DotProductProof(delta, beta, zs[:deg + 1], zs[deg + 1],
                                      zs[deg + 2]))
        r_ints.append(rd.scalars(1)[0])
    final_claims = rd.scalars(len(tabs))
    return (ZKSumcheckInstanceProof(comm_polys, comm_evals, proofs), r_ints,
            final_claims, blinds_evals[k - 1])


# ---------------------------------------------------------------------------
# Batched grand-product layer proofs (Spark)
# ---------------------------------------------------------------------------

def prove_product_layers_device(prod, dotp, transcript):
    """Device replacement for ProductCircuitEvalProofBatched.prove
    (product_tree.rs:258-382): every layer's rounds and claims on the
    device, ONE fetch at the end.  prod: ProductCircuitBatch; dotp:
    DotProductCircuitBatch or None.  Returns (proof, the last layer's
    challenges) like the host path."""
    from .product_tree import LayerProofBatched, ProductCircuitEvalProofBatched
    from .sumcheck import SumcheckInstanceProof

    B = prod.left[0].shape[0]
    dev = prod.left[0].device
    claims = fq.mul(prod.left[-1][:, 0], prod.right[-1][:, 0])
    t = DeviceTranscript.from_host(transcript, dev)

    rand: list = []
    out: list = []
    shapes = []  # per layer: (rounds, dot-product circuits)
    for layer_id in range(prod.num_layers - 1, -1, -1):
        A = prod.left[layer_id]
        Bt = prod.right[layer_id]
        m = A.shape[1]
        num_rounds = m.bit_length() - 1
        has_seq = layer_id == 0 and dotp is not None
        if has_seq:
            claims = torch.cat([claims, fq.sum_mod(
                fq.mul(fq.mul(dotp.left, dotp.right), dotp.weight), dim=1)])
        coeffs = torch.stack(t.challenge_vector(b"rand_coeffs_next_layer",
                                                claims.shape[0]))
        claim = limb.unpack(fq.dot_mod(coeffs, claims))
        C_b = _eq_table_dev(rand, dev)[None].expand(B, m, limb.NWORDS)
        if has_seq:
            A = torch.cat([A, dotp.left])
            Bt = torch.cat([Bt, dotp.right])
            C_b = torch.cat([C_b, dotp.weight])
        tables = [A, Bt, C_b]

        r_round = []
        if num_rounds:
            tables, ev = fold_evals(tables, None, "evals")
        for j in range(num_rounds):
            e = limb.unpack(fq.dot_mod(ev, coeffs[None], dim=1))
            poly = unipoly_from_evals([e[0], e[1], e[2]], claim)
            unipoly_append(t, b"poly", poly)
            r_j = t.challenge_scalar(b"challenge_nextround")
            r_round.append(r_j)
            mode = "fold_evals" if j + 1 < num_rounds else "fold"
            tables, ev = fold_evals(tables, r_j, mode)
            claim = unipoly_evaluate(poly, limb.unpack(r_j))
            out.append(limb.pack(poly[[0, 2, 3]]))
        A, Bt, C_b = (x[:, 0] for x in tables)

        cl, cr = scalar_to_bytes32(A[:B]), scalar_to_bytes32(Bt[:B])
        for i in range(B):
            t.append_message(b"claim_prod_left", cl[i])
            t.append_message(b"claim_prod_right", cr[i])
        ndotp = A.shape[0] - B
        if ndotp:
            dl, dr_, dw = (scalar_to_bytes32(x[B:]) for x in (A, Bt, C_b))
            for i in range(ndotp):
                t.append_message(b"claim_dotp_left", dl[i])
                t.append_message(b"claim_dotp_right", dr_[i])
                t.append_message(b"claim_dotp_weight", dw[i])
        r_layer = t.challenge_scalar(b"challenge_r_layer")
        claims = fq.add(A[:B], fq.mul(r_layer[None], fq.sub(Bt[:B], A[:B])))
        rand = [r_layer] + r_round
        out += [A[:B], Bt[:B], A[B:], Bt[B:], C_b[B:]]
        shapes.append((num_rounds, ndotp))

    rd = _fetch(out + rand, t, transcript)
    layers = []
    claims_dotp = ([], [], [])
    for num_rounds, ndotp in shapes:
        compressed = [rd.scalars(3) for _ in range(num_rounds)]
        left, right = rd.scalars(B), rd.scalars(B)
        d = (rd.scalars(ndotp), rd.scalars(ndotp), rd.scalars(ndotp))
        if ndotp:
            claims_dotp = d
        layers.append(LayerProofBatched(SumcheckInstanceProof(compressed),
                                        left, right))
    rand_ints = rd.scalars(len(rand))
    return ProductCircuitEvalProofBatched(layers, claims_dotp), rand_ints


# ---------------------------------------------------------------------------
# DotProductProofLog with its bullet rounds (nizk/mod.rs:421-578,
# nizk/bullet.rs:32-135)
# ---------------------------------------------------------------------------

def dotproduct_log_device(gens, transcript, tape, x_dev, blind_x: int,
                          a_dev, a_ints: list, y: int, blind_y: int):
    """Device replacement for DotProductProofLog.prove (the JAX package's
    ``device_prover.py:639-889``): the same arguments and results
    (proof, Cx, Cy), the host ``transcript`` advanced to the same final
    state.  Every round on the device with the transcript on the card:
    K6 cross, K5 (L, R), K4, K3 absorbs them and squeezes u, K6 folds by
    u read through its pointer and K5 folds the generators; the head's
    Cx, Cy and Q and the tail's delta and beta are K5 too, r and c go to
    K6.  One packed fetch."""
    from .dotproduct_log import DotProductProofLog

    n = x_dev.shape[0]
    assert gens.n == n and n >= 2
    lg_n = n.bit_length() - 1
    dev = x_dev.device

    # RandomTape draws, reference order (the duplicated "r_delta" label
    # of nizk/mod.rs:446-448 included)
    d = tape.random_scalar(b"d")
    r_delta = tape.random_scalar(b"r_delta")
    r_beta = tape.random_scalar(b"r_delta")
    v1 = tape.random_vector(b"blinds_vec_1", lg_n)
    v2 = tape.random_vector(b"blinds_vec_2", lg_n)

    # one upload: Montgomery scalars, K5's canonical scalars, the
    # transcript state and the points [h_n, g_1, h_1]
    canon = b"".join((x % Q).to_bytes(32, "little") for x in
                     (blind_x, y, blind_y, d, r_delta, d, r_beta))
    st_bytes, pos, pos_begin, flags = DeviceTranscript.host_state(transcript)
    (scal, can, state, pts) = _upload([
        fq.encode_ints([blind_x, blind_y] + [x for p in zip(v1, v2)
                                              for x in p]
                       + [d, r_delta, r_beta]).numpy(),
        np.frombuffer(canon, dtype="<i4"),
        np.frombuffer(st_bytes, dtype="<i4"),
        ed.stack(ed.from_host([gens.gens_n.h, gens.gens_1.G[0],
                               gens.gens_1.h])).numpy()], dev)
    scal = scal.view(-1, limb.NWORDS)
    blinds = scal[2:2 + 2 * lg_n].view(lg_n, 2, limb.NWORDS)
    drr = scal[2 + 2 * lg_n:]
    can = can.view(-1, limb.NWORDS)
    t = DeviceTranscript(None, _state=state.view(torch.uint8), _pos=pos,
                         _pos_begin=pos_begin, _flags=flags)
    t.append_protocol_name(DotProductProofLog.PROTOCOL)

    # Cx = <x, G> + blind_x h_n and Cy = y g_1 + blind_y h_1: one launch
    G = gens.gens_n.points(dev)
    enc_c = compress(ed.unstack(point_msm(
        torch.cat([G, pts]), torch.cat([fq.from_mont(x_dev), can[:3]]),
        (0, n + 1, n + 3))))
    t.append_point(b"Cx", _as_bytes(enc_c[0]))
    t.append_point(b"Cy", _as_bytes(enc_c[1]))
    # [Scalar]::append_to_transcript of the public vector, from the host
    t.append_message(b"a", b"begin_append_vector")
    for v in a_ints:
        t.append_message(b"a", (v % Q).to_bytes(32, "little"))
    t.append_message(b"a", b"end_append_vector")

    # r, blind_Gamma = blind_x + r blind_y (the bullet's blind_fin, which
    # the folds update in place) and Q = r g_1
    head = bullet_step("head", t.challenge_bytes(b"r", 64), scal[0], scal[1])
    blind_fin = head[1]
    Q_pt = point_msm(pts[1:2], head[:1], (0, 1))
    qh = torch.cat([Q_pt, pts[:1]])  # the bullet's Q and H (= h_n)

    a, b, out = x_dev, a_dev, [enc_c]
    for j in range(lg_n):
        enc = round_commit(a, b, G, qh, blinds[j])
        t.append_point(b"L", _as_bytes(enc[0]))
        t.append_point(b"R", _as_bytes(enc[1]))
        a, b, G = round_fold(a, b, G, t.challenge_bytes(b"u", 64),
                             blinds[j], blind_fin)
        out.append(enc)

    # delta = d g_hat + r_delta h_1, beta = d Q + r_beta h_1
    enc_db = compress(ed.unstack(point_msm(
        torch.cat([G, pts[2:], Q_pt, pts[2:]]), can[3:], (0, 2, 4))))
    t.append_point(b"delta", _as_bytes(enc_db[0]))
    t.append_point(b"beta", _as_bytes(enc_db[1]))
    z = bullet_step("tail", t.challenge_bytes(b"c", 64), a[0], b[0],
                    blind_fin, drr)
    rd = _fetch(out + [enc_db, z], t, transcript)
    cx, cy = rd.bytes32(), rd.bytes32()
    L_vec, R_vec = [], []
    for _ in range(lg_n):
        L_vec.append(rd.bytes32())
        R_vec.append(rd.bytes32())
    delta, beta = rd.bytes32(), rd.bytes32()
    z1, z2 = rd.scalars(2)
    return (DotProductProofLog(BulletReductionProof(L_vec, R_vec), delta,
                               beta, z1, z2), cx, cy)
