"""Bulletproofs-style inner-product reduction (reference
src/nizk/bullet.rs, itself adapted from the bulletproofs crate).

Host path: every round runs on python ints and host points (the JAX
package's default too, ``bullet.py:28-44``).  At the sizes the prover
sees (the R side of the witness matrix, 2^10 at 2^20 constraints) a
round is a few milliseconds of native C++; the device rounds of the JAX
package are not ported.  Transcript I/O is host-side throughout.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core import ristretto as hri
from ..core.edwards import Point, msm_ct
from ..core.field import Q, batch_inv
from ..core.merlin import Transcript
from ..curve import msm as dmsm
from ..ff import fq
from ..utils.errors import ProofVerifyError


@dataclass
class BulletReductionProof:
    L_vec: list  # bytes
    R_vec: list  # bytes

    @staticmethod
    def prove(transcript: Transcript, Q_pt: Point, G: list[Point],
              H: Point, a: torch.Tensor, b: torch.Tensor,
              blind: int, blinds_vec: list[tuple[int, int]]):
        """a, b: (n, 8) Montgomery tables, n a power of two; G: host
        generators.  Returns (proof, Gamma_hat, a_hat, b_hat, g_hat,
        blind_final) mirroring bullet.rs:32-135."""
        n = a.shape[0]
        assert n & (n - 1) == 0 and len(G) == n
        lg_n = n.bit_length() - 1
        assert len(blinds_vec) == lg_n

        L_vec, R_vec = [], []
        blind_fin = blind % Q
        it = iter(blinds_vec)
        dev = a.device
        a_i = fq.decode_to_ints(a)
        b_i = fq.decode_to_ints(b)
        G_h = list(G)
        while n != 1:
            n //= 2
            a_L, a_R = a_i[:n], a_i[n:]
            b_L, b_R = b_i[:n], b_i[n:]
            G_L, G_R = G_h[:n], G_h[n:]
            c_L = sum(x * y for x, y in zip(a_L, b_R)) % Q
            c_R = sum(x * y for x, y in zip(a_R, b_L)) % Q
            blind_L, blind_R = next(it)
            # cross-term MSM vartime (as the reference's bullet.rs does
            # for the same data); the secret c/blind completion terms on
            # the constant-time ladder
            L = dmsm.vmsm(a_L, G_R, dev).add(msm_ct([c_L, blind_L], [Q_pt, H]))
            R = dmsm.vmsm(a_R, G_L, dev).add(msm_ct([c_R, blind_R], [Q_pt, H]))
            Lb, Rb = hri.encode(L), hri.encode(R)
            transcript.append_point(b"L", Lb)
            transcript.append_point(b"R", Rb)
            u = transcript.challenge_scalar(b"u")
            u_inv = pow(u, -1, Q)
            a_i = [(x * u + u_inv * y) % Q for x, y in zip(a_L, a_R)]
            b_i = [(x * u_inv + u * y) % Q for x, y in zip(b_L, b_R)]
            G_h = [gl.mul(u_inv).add(gr.mul(u)) for gl, gr in zip(G_L, G_R)]
            blind_fin = (blind_fin + blind_L * u * u + blind_R * u_inv * u_inv) % Q
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
