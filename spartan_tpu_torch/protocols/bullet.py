"""Bulletproofs-style inner-product reduction (reference
src/nizk/bullet.rs, itself adapted from the bulletproofs crate).

Each round halves a, b and the generators G.  While the half size n/2
is at least ``DEVICE_MIN`` of the tensors' device type, a round runs on
the device, as the JAX package's device rounds (``bullet.py:47-148``)
do: kernel K6 (``ff.bullet_kernel``) computes the cross products and
writes the scalar rows, kernel K5 (``curve.point_msm``) the cross terms
L and R, kernel K4 (``curve.ristretto.compress``) their encodings, which
come to the host in one 64-byte fetch for the host transcript; the
challenge u goes back up by value, K6 folds a and b and K5 the
generators.  The smaller rounds run on the host (python ints and the
native library's ladders) on a, b, G and blind_fin fetched in one go.
The bytes are the same either way.  ``DEVICE_MIN`` is a constant of the
measurement, not an option: the JAX package kept its device rounds off
by default only for their TPU compile cost (one ladder executable per
halved shape), which the port does not pay.  Transcript I/O is
host-side.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import torch

from ..commitments import MultiCommitGens
from ..core import ristretto as hri
from ..core.edwards import Point, msm_ct
from ..core.field import Q, batch_inv
from ..core.merlin import Transcript
from ..curve import edwards as ed
from ..curve import msm as dmsm
from ..curve.point_msm import point_msm
from ..curve.ristretto import compress
from ..ff import fq, limb
from ..ff.bullet_kernel import bullet_step
from ..utils import rt
from ..utils.errors import ProofVerifyError

# The smallest half size n/2 from which a device round beats a host round,
# by device type: on the H100 from chip_smoke.py's round comparison
# ("bullet round n ..." at n = 2^1 ... 2^12, PERF.md section 6); on the
# CPU the kernels' plain versions lose to the native host rounds at every
# size.
DEVICE_MIN = {"cuda": 4, "cpu": math.inf}


@functools.lru_cache(maxsize=32)
def _pair_offsets(m: int) -> tuple:
    return tuple(range(0, 2 * m + 1, 2))


def round_commit(a: torch.Tensor, b: torch.Tensor, G: torch.Tensor,
                 qh: torch.Tensor, blinds: torch.Tensor) -> torch.Tensor:
    """A device round's L = <a_L, G_R> + c_L Q + blind_L H and R = <a_R,
    G_L> + c_R Q + blind_R H (bullet.rs:70-113), encoded: (2, 8) int32.
    a, b: (n, 8) Montgomery; G: (n, 4, 8) points; qh: (2, 4, 8) = Q, H;
    blinds: (2, 8) Montgomery.  One K6, one K5 and one K4 launch."""
    m = a.shape[0] // 2
    rows = bullet_step("cross", a, b, blinds)
    LR = point_msm(torch.cat([G[m:], qh, G[:m], qh]),
                   rows.view(-1, limb.NWORDS), (0, m + 2, 2 * m + 4))
    return compress(ed.unstack(LR))


def round_fold(a: torch.Tensor, b: torch.Tensor, G: torch.Tensor,
               u: torch.Tensor, blinds: torch.Tensor,
               blind_fin: torch.Tensor):
    """Fold a device round by its challenge u (bullet.rs:116-124): (a',
    b', G') with G'[i] = u^-1 G_L[i] + u G_R[i]; blind_fin (8,)
    Montgomery gains blind_L u^2 + blind_R u^-2 in place.  One K6 and
    one K5 launch."""
    m = a.shape[0] // 2
    a, b, gsc = bullet_step("fold", a, b, u, blinds, blind_fin)
    pairs = torch.stack([G[:m], G[m:]], dim=1).view(2 * m, 4, limb.NWORDS)
    return a, b, point_msm(pairs, gsc.view(2 * m, limb.NWORDS),
                           _pair_offsets(m))


def device_round(transcript: Transcript, a: torch.Tensor, b: torch.Tensor,
                 G: torch.Tensor, qh: torch.Tensor, blinds: torch.Tensor,
                 blind_fin: torch.Tensor):
    """One round on the device beside the host transcript: round_commit,
    ONE 64-byte fetch of L and R for the transcript, the challenge u
    uploaded by value, round_fold.  Returns (a', b', G', L, R)."""
    raw = rt.fetch(round_commit(a, b, G, qh, blinds)).astype("<i4").tobytes()
    Lb, Rb = raw[:32], raw[32:]
    transcript.append_point(b"L", Lb)
    transcript.append_point(b"R", Rb)
    u = transcript.challenge_scalar(b"u")
    a, b, G = round_fold(a, b, G, fq.mont_limbs(u, a.device), blinds,
                         blind_fin)
    return a, b, G, Lb, Rb


def host_round(transcript: Transcript, Q_pt: Point, H: Point, a: list,
               b: list, G: list, blind_L: int, blind_R: int, blind_fin: int,
               device=None):
    """One round on the host: python ints a, b and host points G.
    Returns (a', b', G', blind_fin', L, R)."""
    n = len(a) // 2
    a_L, a_R = a[:n], a[n:]
    b_L, b_R = b[:n], b[n:]
    G_L, G_R = G[:n], G[n:]
    c_L = sum(x * y for x, y in zip(a_L, b_R)) % Q
    c_R = sum(x * y for x, y in zip(a_R, b_L)) % Q
    # cross-term MSM vartime (as the reference's bullet.rs does for the
    # same data); the secret c/blind completion terms on the
    # constant-time ladder
    L = dmsm.vmsm(a_L, G_R, device).add(msm_ct([c_L, blind_L], [Q_pt, H]))
    R = dmsm.vmsm(a_R, G_L, device).add(msm_ct([c_R, blind_R], [Q_pt, H]))
    Lb, Rb = hri.encode(L), hri.encode(R)
    transcript.append_point(b"L", Lb)
    transcript.append_point(b"R", Rb)
    u = transcript.challenge_scalar(b"u")
    u_inv = pow(u, -1, Q)
    a = [(x * u + u_inv * y) % Q for x, y in zip(a_L, a_R)]
    b = [(x * u_inv + u * y) % Q for x, y in zip(b_L, b_R)]
    G = [gl.mul(u_inv).add(gr.mul(u)) for gl, gr in zip(G_L, G_R)]
    blind_fin = (blind_fin + blind_L * u * u + blind_R * u_inv * u_inv) % Q
    return a, b, G, blind_fin, Lb, Rb


@dataclass
class BulletReductionProof:
    L_vec: list  # bytes
    R_vec: list  # bytes

    @staticmethod
    def prove(transcript: Transcript, Q_pt: Point, gens: MultiCommitGens,
              a: torch.Tensor, b: torch.Tensor,
              blind: int, blinds_vec: list[tuple[int, int]]):
        """a, b: (n, 8) Montgomery tables, n a power of two; gens: the n
        generators G and the blinding generator H = gens.h.  Returns
        (proof, Gamma_hat, a_hat, b_hat, g_hat, blind_final) mirroring
        bullet.rs:32-135."""
        n = a.shape[0]
        assert n & (n - 1) == 0 and gens.n == n
        lg_n = n.bit_length() - 1
        assert len(blinds_vec) == lg_n
        H = gens.h

        L_vec, R_vec = [], []
        blind_fin = blind % Q
        dev = a.device
        dev_min = DEVICE_MIN[dev.type]
        k = 0  # device rounds
        while n >> (k + 1) >= dev_min:
            k += 1
        if k:
            G = gens.points(dev)
            qh = ed.stack(ed.from_host([Q_pt, H], dev))
            up = fq.encode_ints([x for pair in blinds_vec[:k] for x in pair]
                                + [blind_fin], dev)
            blinds, bf = up[:-1].view(k, 2, limb.NWORDS), up[-1]
            for j in range(k):
                a, b, G, Lb, Rb = device_round(transcript, a, b, G, qh,
                                               blinds[j], bf)
                L_vec.append(Lb)
                R_vec.append(Rb)
            n >>= k
            # the host tail's inputs in one fetch
            raw = rt.fetch(torch.cat([a.reshape(-1), b.reshape(-1),
                                      G.reshape(-1), bf])).astype("<i4").tobytes()
            vals = [int.from_bytes(raw[32 * i:32 * i + 32], "little")
                    for i in range(len(raw) // 32)]
            a_i = [x * fq.R_INV % Q for x in vals[:n]]
            b_i = [x * fq.R_INV % Q for x in vals[n:2 * n]]
            G_h = [Point(*vals[2 * n + 4 * i:2 * n + 4 * i + 4])
                   for i in range(n)]
            blind_fin = vals[-1] * fq.R_INV % Q
        else:
            a_i = fq.decode_to_ints(a)
            b_i = fq.decode_to_ints(b)
            G_h = list(gens.G)
        for blind_L, blind_R in blinds_vec[k:]:
            a_i, b_i, G_h, blind_fin, Lb, Rb = host_round(
                transcript, Q_pt, H, a_i, b_i, G_h, blind_L, blind_R,
                blind_fin, dev)
            L_vec.append(Lb)
            R_vec.append(Rb)

        a_hat, b_hat, g_hat = a_i[0], b_i[0], G_h[0]
        # a_hat and blind_fin are secret: constant-time ladder
        Gamma_hat = msm_ct([a_hat, a_hat * b_hat % Q, blind_fin],
                           [g_hat, Q_pt, H])
        return (
            BulletReductionProof(L_vec, R_vec),
            Gamma_hat, a_hat, b_hat, g_hat, blind_fin,
        )

    def verification_scalars(self, n: int, transcript: Transcript):
        """bullet.rs:137-185: recompute challenges; u^2, u^-2 and the
        s-vector."""
        lg_n = len(self.L_vec)
        if lg_n >= 32 or n != (1 << lg_n):
            raise ProofVerifyError("bullet: bad length")
        challenges = []
        for L, R in zip(self.L_vec, self.R_vec):
            transcript.append_point(b"L", L)
            transcript.append_point(b"R", R)
            challenges.append(transcript.challenge_scalar(b"u"))
        challenges_inv = batch_inv(challenges, Q)
        allinv = 1
        for ci in challenges_inv:
            allinv = allinv * ci % Q
        u_sq = [c * c % Q for c in challenges]
        u_inv_sq = [c * c % Q for c in challenges_inv]
        s = [allinv]
        for i in range(1, n):
            lg_i = i.bit_length() - 1
            k = 1 << lg_i
            s.append(s[i - k] * u_sq[(lg_n - 1) - lg_i] % Q)
        return u_sq, u_inv_sq, s

    def verify(self, n: int, a: list[int], transcript: Transcript,
               Gamma: Point, G: list[Point], device=None):
        """bullet.rs:191-225.  a: public vector ints; G: host gens;
        ``device`` runs the MSMs too large for the host
        (``curve.msm.vmsm``).  Returns (g_hat, Gamma_hat, a_hat)."""
        u_sq, u_inv_sq, s = self.verification_scalars(n, transcript)
        Ls = [hri.decode(x) for x in self.L_vec]
        Rs = [hri.decode(x) for x in self.R_vec]
        if any(x is None for x in Ls + Rs):
            raise ProofVerifyError("bullet: decompression")
        G_hat = dmsm.vmsm(s, G, device)
        a_hat = sum(x * y for x, y in zip(a, s)) % Q
        Gamma_hat = dmsm.vmsm(u_sq + u_inv_sq + [1], Ls + Rs + [Gamma],
                              device)
        return G_hat, Gamma_hat, a_hat
