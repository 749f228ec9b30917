"""Spartan's verifiers, NIZK and SNARK, in plain Python.

Each check raises ``Reject`` with the reason; a proof that returns has
been accepted.  Labels and the order of the transcript are upstream's
(``r1csproof.rs``, ``nizk/mod.rs``, ``nizk/bullet.rs``,
``dense_mlpoly.rs``, ``sparse_mlpoly.rs``, ``product_tree.rs``,
``sumcheck.rs``)."""

from __future__ import annotations

from types import SimpleNamespace as NS

from . import group as G
from .field import Q, batch_inv, eq_eval, eq_table, fold_low, log2, next_pow2
from .transcript import Transcript


class Reject(Exception):
    pass


def _pt(b: bytes):
    p = G.decode(b)
    if p is None:
        raise Reject("point does not decode")
    return p


class Gens:
    """Pedersen generators of one label: ``G`` (n points) and ``h``."""

    def __init__(self, G_pts: list, h):
        self.G, self.h = G_pts, h

    @staticmethod
    def multi(stream: list, n: int) -> "Gens":
        """MultiCommitGens(n, label): the stream's first n points, the
        next one blinds."""
        return Gens(stream[:n], stream[n])

    @staticmethod
    def dot(stream: list, n: int) -> tuple["Gens", "Gens"]:
        """DotProductProofGens(n, label): (gens_n, gens_1)."""
        return Gens(stream[:n], stream[n + 1]), Gens([stream[n]],
                                                     stream[n + 1])


def sat_gens(num_vars: int, label: bytes = b"gens_r1cs_sat"):
    """R1CSGens: the witness commitment's and the sum-checks'."""
    ell = log2(num_vars)
    right = ell - ell // 2
    stream = G.derive_generators(label, max((1 << right) + 2, 5))
    gens_n, gens_1 = Gens.dot(stream, 1 << right)
    return NS(pc_n=gens_n, pc_1=gens_1, sc_1=gens_1,
              sc_3=Gens.multi(stream, 3), sc_4=Gens.multi(stream, 4))


def spark_gens(num_cons: int, num_vars: int, nnz: int, batch: int = 3,
               label: bytes = b"gens_r1cs_eval"):
    """SparseMatPolyCommitmentGens for the R1CS matrices."""
    vx, vy = log2(num_cons), log2(2 * num_vars)
    ells = dict(ops=log2(next_pow2(nnz)) + log2(next_pow2(batch * 5)),
                mem=max(vx, vy) + 1,
                derefs=log2(next_pow2(nnz)) + log2(next_pow2(batch * 2)))
    rights = {k: e - e // 2 for k, e in ells.items()}
    stream = G.derive_generators(label, (1 << max(rights.values())) + 2)
    return NS(ells=ells, **{k: Gens.dot(stream, 1 << rights[k])
                            for k in ells})


def commit_scalar(x: int, blind: int, gens: Gens):
    return G.msm([x, blind], [gens.G[0], gens.h])


# ---------------------------------------------------------------- sigma

def knowledge_verify(p, gens_1: Gens, t: Transcript, C: bytes) -> None:
    t.append_protocol_name(b"knowledge proof")
    t.append_point(b"C", C)
    t.append_point(b"alpha", p.alpha)
    c = t.challenge_scalar(b"c")
    lhs = commit_scalar(p.z1, p.z2, gens_1)
    rhs = G.add(G.mul(_pt(C), c), _pt(p.alpha))
    if not G.equal(lhs, rhs):
        raise Reject("knowledge proof")


def equality_verify(p, gens_1: Gens, t: Transcript, C1: bytes,
                    C2: bytes) -> None:
    t.append_protocol_name(b"equality proof")
    t.append_point(b"C1", C1)
    t.append_point(b"C2", C2)
    t.append_point(b"alpha", p.alpha)
    c = t.challenge_scalar(b"c")
    diff = G.add(_pt(C1), G.neg(_pt(C2)))
    if not G.equal(G.mul(gens_1.h, p.z),
                   G.add(G.mul(diff, c), _pt(p.alpha))):
        raise Reject("equality proof")


def product_verify(p, gens_1: Gens, t: Transcript, X: bytes, Y: bytes,
                   Z: bytes) -> None:
    t.append_protocol_name(b"product proof")
    for label, v in ((b"X", X), (b"Y", Y), (b"Z", Z), (b"alpha", p.alpha),
                     (b"beta", p.beta), (b"delta", p.delta)):
        t.append_point(label, v)
    c = t.challenge_scalar(b"c")
    z1, z2, z3, z4, z5 = p.z

    def holds(Pb, Xb, base, za, zb):
        lhs = G.add(_pt(Pb), G.mul(_pt(Xb), c))
        return G.equal(lhs, G.msm([za, zb], [base, gens_1.h]))

    if not (holds(p.alpha, X, gens_1.G[0], z1, z2)
            and holds(p.beta, Y, gens_1.G[0], z3, z4)
            and holds(p.delta, Z, _pt(X), z3, z5)):
        raise Reject("product proof")


def dot_verify(p, gens_1: Gens, gens_n: Gens, t: Transcript, a: list[int],
               Cx: bytes, Cy: bytes) -> None:
    if len(a) != len(gens_n.G) or len(p.z) != len(a):
        raise Reject("dot product proof: sizes")
    t.append_protocol_name(b"dot product proof")
    t.append_point(b"Cx", Cx)
    t.append_point(b"Cy", Cy)
    t.append_scalars(b"a", a)
    t.append_point(b"delta", p.delta)
    t.append_point(b"beta", p.beta)
    c = t.challenge_scalar(b"c")
    lhs1 = G.add(G.mul(_pt(Cx), c), _pt(p.delta))
    rhs1 = G.msm(list(p.z) + [p.z_delta], gens_n.G + [gens_n.h])
    za = sum(x * y for x, y in zip(p.z, a)) % Q
    lhs2 = G.add(G.mul(_pt(Cy), c), _pt(p.beta))
    rhs2 = commit_scalar(za, p.z_beta, gens_1)
    if not (G.equal(lhs1, rhs1) and G.equal(lhs2, rhs2)):
        raise Reject("dot product proof")


def bullet_verify(L: list[bytes], R: list[bytes], n: int, a: list[int],
                  t: Transcript, Gamma, G_pts: list):
    lg = len(L)
    if len(R) != lg or lg >= 32 or n != 1 << lg:
        raise Reject("bullet: length")
    us = []
    for l, r in zip(L, R):
        t.append_point(b"L", l)
        t.append_point(b"R", r)
        us.append(t.challenge_scalar(b"u"))
    u_inv = batch_inv(us)
    allinv = 1
    for x in u_inv:
        allinv = allinv * x % Q
    u_sq = [u * u % Q for u in us]
    u_inv_sq = [u * u % Q for u in u_inv]
    s = [allinv]
    for i in range(1, n):
        k = i.bit_length() - 1
        s.append(s[i - (1 << k)] * u_sq[lg - 1 - k] % Q)
    g_hat = G.msm(s, G_pts)
    a_hat = sum(x * y for x, y in zip(a, s)) % Q
    Gamma_hat = G.msm(u_sq + u_inv_sq + [1],
                      [_pt(x) for x in L] + [_pt(x) for x in R] + [Gamma])
    return g_hat, Gamma_hat, a_hat


def dot_log_verify(p, gens_n: Gens, gens_1: Gens, t: Transcript,
                   a: list[int], Cx: bytes, Cy: bytes) -> None:
    n = len(gens_n.G)
    if len(a) != n:
        raise Reject("dot product (log): sizes")
    t.append_protocol_name(b"dot product proof (log)")
    t.append_point(b"Cx", Cx)
    t.append_point(b"Cy", Cy)
    t.append_scalars(b"a", a)
    r = t.challenge_scalar(b"r")
    Q_scaled = G.mul(gens_1.G[0], r)
    Gamma = G.add(_pt(Cx), G.mul(_pt(Cy), r))
    g_hat, Gamma_hat, a_hat = bullet_verify(p.L, p.R, n, a, t, Gamma,
                                            gens_n.G)
    t.append_point(b"delta", p.delta)
    t.append_point(b"beta", p.beta)
    c = t.challenge_scalar(b"c")
    lhs = G.add(G.mul(G.add(G.mul(Gamma_hat, c), _pt(p.beta)), a_hat),
                _pt(p.delta))
    rhs = G.add(G.mul(G.add(g_hat, G.mul(Q_scaled, a_hat)), p.z1),
                G.mul(gens_1.h, p.z2))
    if not G.equal(lhs, rhs):
        raise Reject("dot product (log) proof")


def poly_eval_verify(p, gens_n: Gens, gens_1: Gens, t: Transcript,
                     r: list[int], C_Zr: bytes, comm: list) -> None:
    """PolyEvalProof::verify; ``comm`` the row commitments as points."""
    t.append_protocol_name(b"polynomial evaluation proof")
    left = len(r) // 2
    L_tab, R_tab = eq_table(r[:left]), eq_table(r[left:])
    if len(comm) != len(L_tab):
        raise Reject("poly commitment: rows")
    C_LZ = G.encode(G.msm(L_tab, comm))
    dot_log_verify(p, gens_n, gens_1, t, R_tab, C_LZ, C_Zr)


def poly_eval_verify_plain(p, gens_n, gens_1, t, r, Zr, comm) -> None:
    poly_eval_verify(p, gens_n, gens_1, t, r,
                     G.encode(commit_scalar(Zr, 0, gens_1)), comm)


def append_poly_commitment(t: Transcript, label: bytes,
                           points: list[bytes]) -> None:
    t.append_message(label, b"poly_commitment_begin")
    for c in points:
        t.append_point(b"poly_commitment_share", c)
    t.append_message(label, b"poly_commitment_end")


# ------------------------------------------------------------ sum-checks

def _decompress_poly(coeffs: list[int], hint: int) -> list[int]:
    linear = (hint - 2 * coeffs[0] - sum(coeffs[1:])) % Q
    return [coeffs[0], linear] + list(coeffs[1:])


def _poly_eval(c: list[int], r: int) -> int:
    acc = 0
    for x in reversed(c):
        acc = (acc * r + x) % Q
    return acc


def sumcheck_verify(polys: list, claim: int, rounds: int, degree: int,
                    t: Transcript) -> tuple[int, list[int]]:
    if len(polys) != rounds or any(len(c) != degree for c in polys):
        raise Reject("sum-check: rounds or degree")
    e, rs = claim % Q, []
    for comp in polys:
        c = _decompress_poly(comp, e)
        if (c[0] + sum(c)) % Q != e:
            raise Reject("sum-check: round sum")
        t.append_message(b"poly", b"UniPoly_begin")
        for x in c:
            t.append_scalar(b"coeff", x)
        t.append_message(b"poly", b"UniPoly_end")
        r = t.challenge_scalar(b"challenge_nextround")
        rs.append(r)
        e = _poly_eval(c, r)
    return e, rs


def zk_sumcheck_verify(p, comm_claim: bytes, rounds: int, degree: int,
                       gens_1: Gens, gens_n: Gens, t: Transcript):
    if len(gens_n.G) != degree + 1:
        raise Reject("zk sum-check: generators")
    if not (len(p.comm_polys) == len(p.comm_evals) == len(p.proofs)
            == rounds):
        raise Reject("zk sum-check: rounds")
    rs = []
    for i in range(rounds):
        t.append_point(b"comm_poly", p.comm_polys[i])
        r = t.challenge_scalar(b"challenge_nextround")
        prev = comm_claim if i == 0 else p.comm_evals[i - 1]
        t.append_point(b"comm_claim_per_round", prev)
        t.append_point(b"comm_eval", p.comm_evals[i])
        w = t.challenge_vector(b"combine_two_claims_to_one", 2)
        target = G.encode(G.msm(w, [_pt(prev), _pt(p.comm_evals[i])]))
        a_sc = [2] + [1] * degree
        a_ev = [1]
        for _ in range(degree):
            a_ev.append(a_ev[-1] * r % Q)
        a = [(w[0] * x + w[1] * y) % Q for x, y in zip(a_sc, a_ev)]
        dot_verify(p.proofs[i], gens_1, gens_n, t, a, p.comm_polys[i],
                   target)
        rs.append(r)
    return p.comm_evals[-1], rs


# ------------------------------------------------------------- R1CS proof

def input_eval(inputs: list[int], ry_tail: list[int]) -> int:
    """The multilinear extension of (1, inputs, 0, ...) at ``ry_tail``."""
    total, ell = 0, len(ry_tail)
    for idx, val in [(0, 1)] + [(i + 1, v) for i, v in enumerate(inputs)]:
        chi = 1
        for j, rj in enumerate(ry_tail):
            bit = (idx >> (ell - j - 1)) & 1
            chi = chi * (rj if bit else 1 - rj) % Q
        total += chi * val
    return total % Q


def sat_verify(p, num_vars: int, num_cons: int, inputs: list[int],
               evals: list[int], t: Transcript, gens):
    """R1CSProof::verify; returns (rx, ry)."""
    t.append_protocol_name(b"R1CS proof")
    t.append_scalars(b"input", inputs)
    append_poly_commitment(t, b"poly_commitment", p.comm_vars)
    rounds_x, rounds_y = log2(num_cons), log2(2 * num_vars)
    tau = t.challenge_vector(b"challenge_tau", rounds_x)

    claim1 = G.encode(G.IDENTITY)
    comm_post1, rx = zk_sumcheck_verify(p.sc1, claim1, rounds_x, 3,
                                        gens.sc_1, gens.sc_4, t)
    cAz, cBz, cCz, cProd = p.claims
    knowledge_verify(p.knowledge, gens.sc_1, t, cCz)
    product_verify(p.product, gens.sc_1, t, cAz, cBz, cProd)
    for label, c in ((b"comm_Az_claim", cAz), (b"comm_Bz_claim", cBz),
                     (b"comm_Cz_claim", cCz),
                     (b"comm_prod_Az_Bz_claims", cProd)):
        t.append_point(label, c)
    taus_rx = eq_eval(rx, tau)
    expected1 = G.encode(G.mul(G.add(_pt(cProd), G.neg(_pt(cCz))),
                               taus_rx))
    equality_verify(p.eq1, gens.sc_1, t, expected1, comm_post1)

    r_A = t.challenge_scalar(b"challenge_Az")
    r_B = t.challenge_scalar(b"challenge_Bz")
    r_C = t.challenge_scalar(b"challenge_Cz")
    claim2 = G.encode(G.msm([r_A, r_B, r_C],
                            [_pt(cAz), _pt(cBz), _pt(cCz)]))
    comm_post2, ry = zk_sumcheck_verify(p.sc2, claim2, rounds_y, 2,
                                        gens.sc_1, gens.sc_3, t)
    comm_rows = [_pt(c) for c in p.comm_vars]
    poly_eval_verify(p.eval_proof, gens.pc_n, gens.pc_1, t, ry[1:],
                     p.comm_vars_at_ry, comm_rows)
    z_in = input_eval(inputs, ry[1:])
    comm_Z = G.msm([1 - ry[0], ry[0]],
                   [_pt(p.comm_vars_at_ry),
                    commit_scalar(z_in, 0, gens.pc_1)])
    scalar = (r_A * evals[0] + r_B * evals[1] + r_C * evals[2]) % Q
    expected2 = G.encode(G.mul(comm_Z, scalar))
    equality_verify(p.eq2, gens.sc_1, t, expected2, comm_post2)
    return rx, ry


def nizk_verify(proof, inst, inputs: list[int], t: Transcript,
                gens) -> None:
    """NIZK::verify from the transcript state after the protocol name
    and the instance digest; ``inst`` evaluates the matrices."""
    evals = inst.evaluate(proof.rx, proof.ry)
    if len(inputs) != inst.num_inputs:
        raise Reject("number of inputs")
    rx, ry = sat_verify(proof.sat, inst.num_vars, inst.num_cons, inputs,
                        evals, t, gens)
    if rx != proof.rx or ry != proof.ry:
        raise Reject("claimed (rx, ry)")


# ------------------------------------------------------------------ Spark

def _append_claims(t: Transcript, which: bytes, four) -> None:
    init, read, write, audit = four
    t.append_scalar(b"claim_" + which + b"_eval_init", init)
    t.append_scalars(b"claim_" + which + b"_eval_read", read)
    t.append_scalars(b"claim_" + which + b"_eval_write", write)
    t.append_scalar(b"claim_" + which + b"_eval_audit", audit)


def _multiset(four) -> bool:
    init, read, write, audit = four
    ws = rs = 1
    for w in write:
        ws = ws * w % Q
    for r in read:
        rs = rs * r % Q
    return init * ws % Q == rs * audit % Q


def prod_circuit_verify(p, claims_prod: list[int], claims_dotp: list[int],
                        n_leaves: int, t: Transcript):
    num_layers = n_leaves.bit_length() - 1
    if len(p.layers) != num_layers:
        raise Reject("product circuit: layers")
    rand: list[int] = []
    claims = list(claims_prod)
    num_prod = len(claims_prod)
    dotp_out: list[int] = []
    for i, layer in enumerate(p.layers):
        last = i == num_layers - 1
        if last:
            claims = claims + list(claims_dotp)
        coeffs = t.challenge_vector(b"rand_coeffs_next_layer", len(claims))
        claim = sum(c * v for c, v in zip(coeffs, claims)) % Q
        claim_last, rand_prod = sumcheck_verify(layer.polys, claim, i, 3, t)
        if len(layer.left) != num_prod or len(layer.right) != num_prod:
            raise Reject("product circuit: claims")
        for k in range(num_prod):
            t.append_scalar(b"claim_prod_left", layer.left[k])
            t.append_scalar(b"claim_prod_right", layer.right[k])
        eq = eq_eval(rand, rand_prod)
        expected = sum(coeffs[k] * (layer.left[k] * layer.right[k] % Q)
                       % Q * eq for k in range(num_prod)) % Q
        if last:
            dl, dr, dw = p.dotp
            if not len(dl) == len(dr) == len(dw) == len(claims_dotp):
                raise Reject("product circuit: dot-product claims")
            for k in range(len(dl)):
                t.append_scalar(b"claim_dotp_left", dl[k])
                t.append_scalar(b"claim_dotp_right", dr[k])
                t.append_scalar(b"claim_dotp_weight", dw[k])
                expected = (expected + coeffs[k + num_prod] * dl[k] % Q
                            * dr[k] % Q * dw[k]) % Q
        if expected != claim_last:
            raise Reject("product layer claim")
        r_layer = t.challenge_scalar(b"challenge_r_layer")
        claims = [(lv + r_layer * (rv - lv)) % Q
                  for lv, rv in zip(layer.left, layer.right)]
        if last:
            dl, dr, dw = p.dotp
            for k in range(len(claims_dotp) // 2):
                for vec in (dl, dr, dw):
                    dotp_out.append(
                        (vec[2 * k] + r_layer * (vec[2 * k + 1]
                                                 - vec[2 * k])) % Q)
        rand = [r_layer] + rand_prod
    return claims, dotp_out, rand


def _joint(t: Transcript, evals: list[int], label: bytes,
           challenge_label: bytes, rand: list[int]):
    t.append_scalars(label, evals)
    ch = t.challenge_vector(challenge_label, log2(len(evals)))
    return fold_low(evals, ch), ch + list(rand)


def _padded(evals: list[int]) -> list[int]:
    return list(evals) + [0] * (next_pow2(len(evals)) - len(evals))


def _hash_check(rand_mem, claims, ops_val, ops_addr, read_ts, audit_ts, r,
                r_hash, r_ms) -> None:
    init, read, write, audit = claims
    r2 = r_hash * r_hash % Q

    def h(a, v, ts):
        return (ts * r2 + v * r_hash + a - r_ms) % Q

    init_addr = 0
    for i, ri in enumerate(rand_mem):
        init_addr = (init_addr + (1 << (len(rand_mem) - i - 1)) * ri) % Q
    init_val = eq_eval(r, rand_mem)
    if h(init_addr, init_val, 0) != init % Q:
        raise Reject("hash layer: init")
    if not (len(ops_addr) == len(ops_val) == len(read_ts) == len(read)
            == len(write)):
        raise Reject("hash layer: counts")
    for i in range(len(ops_addr)):
        if h(ops_addr[i], ops_val[i], read_ts[i]) != read[i] % Q:
            raise Reject("hash layer: read")
        if h(ops_addr[i], ops_val[i], read_ts[i] + 1) != write[i] % Q:
            raise Reject("hash layer: write")
    if h(init_addr, init_val, audit_ts) != audit % Q:
        raise Reject("hash layer: audit")


def spark_verify(p, comm, rows: dict, rx: list[int], ry: list[int],
                 evals: list[int], t: Transcript, gens) -> None:
    """SparseMatPolyEvalProof::verify.  ``comm`` the commitment as read;
    ``rows`` its row commitments as points (``ops``, ``mem``)."""
    t.append_protocol_name(b"Sparse polynomial evaluation proof")
    d = len(ry) - len(rx)
    rx_e, ry_e = [0] * d + list(rx), [0] * -d + list(ry)
    if 1 << len(rx_e) != comm.num_mem_cells:
        raise Reject("spark: point and commitment sizes")
    t.append_message(b"derefs_commitment", b"begin_derefs_commitment")
    append_poly_commitment(t, b"comm_poly_row_col_ops_val", p.comm_derefs)
    t.append_message(b"derefs_commitment", b"end_derefs_commitment")
    r_hash, r_ms = t.challenge_vector(b"challenge_r_hash", 2)

    # PolyEvalNetworkProof
    t.append_protocol_name(b"Sparse polynomial evaluation proof")
    k = len(evals)
    num_ops, num_cells = next_pow2(comm.num_ops), 1 << len(rx_e)
    # the product layer
    t.append_protocol_name(b"Sparse polynomial product layer proof")
    for four in (p.eval_row, p.eval_col):
        if len(four[1]) != k or len(four[2]) != k:
            raise Reject("product layer: instances")
    if not _multiset(p.eval_row):
        raise Reject("row multiset")
    _append_claims(t, b"row", p.eval_row)
    if not _multiset(p.eval_col):
        raise Reject("col multiset")
    _append_claims(t, b"col", p.eval_col)
    if len(p.dotp_left) != k or len(p.dotp_right) != k:
        raise Reject("product layer: dot products")
    claims_dotp_circuit = []
    for i in range(k):
        if (p.dotp_left[i] + p.dotp_right[i]) % Q != evals[i] % Q:
            raise Reject("dot-product split")
        t.append_scalar(b"claim_eval_dotp_left", p.dotp_left[i])
        t.append_scalar(b"claim_eval_dotp_right", p.dotp_right[i])
        claims_dotp_circuit += [p.dotp_left[i], p.dotp_right[i]]
    row_init, row_read, row_write, row_audit = p.eval_row
    col_init, col_read, col_write, col_audit = p.eval_col
    claims_ops, claims_dotp, rand_ops = prod_circuit_verify(
        p.proof_ops, list(row_read) + list(row_write) + list(col_read)
        + list(col_write), claims_dotp_circuit, num_ops, t)
    claims_mem, _, rand_mem = prod_circuit_verify(
        p.proof_mem, [row_init, row_audit, col_init, col_audit], [],
        num_cells, t)
    if (len(claims_mem) != 4 or len(claims_ops) != 4 * k
            or len(claims_dotp) != 3 * k):
        raise Reject("eval network: claims")

    # the hash layer
    t.append_protocol_name(b"Sparse polynomial hash layer proof")
    row_ops_val, col_ops_val = p.eval_derefs
    if len(row_ops_val) != len(col_ops_val):
        raise Reject("hash layer: derefs")
    t.append_protocol_name(b"Derefs evaluation proof")
    joint, r_joint = _joint(t, _padded(list(row_ops_val) + list(col_ops_val)),
                            b"evals_ops_val", b"challenge_combine_n_to_one",
                            rand_ops)
    t.append_scalar(b"joint_claim_eval", joint)
    poly_eval_verify_plain(p.pe_derefs, *gens.derefs, t, r_joint, joint,
                           [_pt(c) for c in p.comm_derefs])
    if len(claims_dotp) != 3 * len(row_ops_val) or \
            len(p.eval_val) < len(row_ops_val):
        raise Reject("hash layer: dot-product claims")
    for i in range(len(claims_dotp) // 3):
        if (claims_dotp[3 * i] != row_ops_val[i] % Q
                or claims_dotp[3 * i + 1] != col_ops_val[i] % Q
                or claims_dotp[3 * i + 2] != p.eval_val[i] % Q):
            raise Reject("hash layer: dot-product claims differ")
    row_addr, row_read_ts, row_audit_ts = p.hash_row
    col_addr, col_read_ts, col_audit_ts = p.hash_col
    evals_ops = _padded(list(row_addr) + list(row_read_ts) + list(col_addr)
                        + list(col_read_ts) + list(p.eval_val))
    joint, r_joint = _joint(t, evals_ops, b"claim_evals_ops",
                            b"challenge_combine_n_to_one", rand_ops)
    t.append_scalar(b"joint_claim_eval_ops", joint)
    poly_eval_verify_plain(p.pe_ops, *gens.ops, t, r_joint, joint,
                           rows["ops"])
    joint, r_joint = _joint(t, [row_audit_ts, col_audit_ts],
                            b"claim_evals_mem",
                            b"challenge_combine_two_to_one", rand_mem)
    t.append_scalar(b"joint_claim_eval_mem", joint)
    poly_eval_verify_plain(p.pe_mem, *gens.mem, t, r_joint, joint,
                           rows["mem"])
    _hash_check(rand_mem, (claims_mem[0], claims_ops[:k],
                           claims_ops[k:2 * k], claims_mem[1]),
                row_ops_val, row_addr, row_read_ts, row_audit_ts, rx_e,
                r_hash, r_ms)
    _hash_check(rand_mem, (claims_mem[2], claims_ops[2 * k:3 * k],
                           claims_ops[3 * k:], claims_mem[3]),
                col_ops_val, col_addr, col_read_ts, col_audit_ts, ry_e,
                r_hash, r_ms)


def append_commitment(t: Transcript, comm) -> None:
    """ComputationCommitment::append_to_transcript, label ``comm``."""
    t.append_u64(b"num_cons", comm.num_cons)
    t.append_u64(b"num_vars", comm.num_vars)
    t.append_u64(b"num_inputs", comm.num_inputs)
    t.append_u64(b"batch_size", comm.batch_size)
    t.append_u64(b"num_ops", comm.num_ops)
    t.append_u64(b"num_mem_cells", comm.num_mem_cells)
    append_poly_commitment(t, b"comm_comb_ops", comm.comb_ops)
    append_poly_commitment(t, b"comm_comb_mem", comm.comb_mem)


def snark_verify(proof, comm, rows: dict, inputs: list[int],
                 t: Transcript, sat, spark) -> None:
    """SNARK::verify from the transcript state after the protocol name
    and the commitment."""
    if len(inputs) != comm.num_inputs:
        raise Reject("number of inputs")
    rx, ry = sat_verify(proof.sat, comm.num_vars, comm.num_cons, inputs,
                        proof.evals, t, sat)
    for label, e in zip((b"Ar_claim", b"Br_claim", b"Cr_claim"),
                        proof.evals):
        t.append_scalar(label, e)
    spark_verify(proof.spark, comm, rows, rx, ry, proof.evals, t, spark)
