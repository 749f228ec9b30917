"""DotProductProofLog (reference nizk/mod.rs:421-578): log-size ZK
dot-product argument via the bullet reduction.  The witness vector and
the public vector are device tables; transcript and final sigma algebra
are host-side; the large bullet rounds run on the device (``bullet.py``),
and with them the commitment Cx (kernel K5, constant time).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..commitments import commit_scalar, commit_vector_host
from ..core import ristretto as hri
from ..core.edwards import msm_ct
from ..core.field import Q
from ..core.merlin import RandomTape, Transcript
from ..curve import edwards as ded
from ..curve.point_msm import point_msm
from ..curve.ristretto import compress
from ..ff import fq, limb
from ..utils import rt
from ..utils.errors import ProofVerifyError
from .bullet import DEVICE_MIN, BulletReductionProof
from .sigma import DotProductProofGens, _decompress

@dataclass
class DotProductProofLog:
    bullet_reduction_proof: BulletReductionProof
    delta: bytes
    beta: bytes
    z1: int
    z2: int

    PROTOCOL = b"dot product proof (log)"

    @staticmethod
    def prove(gens: DotProductProofGens, transcript: Transcript,
              tape: RandomTape, x_dev: torch.Tensor, blind_x: int,
              a_dev: torch.Tensor, a_ints: list[int], y: int, blind_y: int
              ) -> tuple["DotProductProofLog", bytes, bytes]:
        """x_dev / a_dev: (n, 8) Montgomery tables; a_ints: the same
        public vector as ints (for the transcript append)."""
        transcript.append_protocol_name(DotProductProofLog.PROTOCOL)
        n = x_dev.shape[0]
        assert gens.n == n

        # randomness; NB the reference draws r_beta under the label
        # "r_delta" too (nizk/mod.rs:446-448) — reproduced exactly.
        d = tape.random_scalar(b"d")
        r_delta = tape.random_scalar(b"r_delta")
        r_beta = tape.random_scalar(b"r_delta")
        lg_n = n.bit_length() - 1
        v1 = tape.random_vector(b"blinds_vec_1", lg_n)
        v2 = tape.random_vector(b"blinds_vec_2", lg_n)
        blinds_vec = list(zip(v1, v2))

        # the secret x and blind_x committed in constant time: with the
        # device rounds by K5 (one launch, K4, one 32-byte fetch), below
        # them on the host ladder
        dev = x_dev.device
        if n // 2 >= DEVICE_MIN[dev.type]:
            pts = torch.cat([gens.gens_n.points(dev),
                             ded.stack(ded.from_host([gens.gens_n.h], dev))])
            s = torch.cat([fq.from_mont(x_dev),
                           limb.ints_to_limbs([blind_x % Q], dev)])
            Cx = rt.fetch(compress(ded.unstack(point_msm(
                pts, s, (0, n + 1))))).astype("<i4").tobytes()
        else:
            Cx = hri.encode(commit_vector_host(
                fq.decode_to_ints(x_dev), blind_x, gens.gens_n))
        transcript.append_point(b"Cx", Cx)

        Cy = hri.encode(commit_scalar(y, blind_y, gens.gens_1))
        transcript.append_point(b"Cy", Cy)
        transcript.append_scalar_vector(b"a", a_ints)

        r = transcript.challenge_scalar(b"r")
        Q_scaled = gens.gens_1.G[0].mul(r)

        blind_Gamma = (blind_x + r * blind_y) % Q
        (bullet_proof, _Gamma_hat, x_hat, a_hat, g_hat, rhat_Gamma) = (
            BulletReductionProof.prove(
                transcript, Q_scaled, gens.gens_n, x_dev, a_dev,
                blind_Gamma, blinds_vec,
            )
        )
        y_hat = x_hat * a_hat % Q

        # d / r_delta / r_beta are tape secrets: constant-time ladder
        delta = hri.encode(msm_ct([d, r_delta], [g_hat, gens.gens_1.h]))
        transcript.append_point(b"delta", delta)
        beta = hri.encode(msm_ct([d, r_beta], [Q_scaled, gens.gens_1.h]))
        transcript.append_point(b"beta", beta)

        c = transcript.challenge_scalar(b"c")
        z1 = (d + c * y_hat) % Q
        z2 = (a_hat * (c * rhat_Gamma + r_beta) + r_delta) % Q
        return DotProductProofLog(bullet_proof, delta, beta, z1, z2), Cx, Cy

    def verify(self, n: int, gens: DotProductProofGens,
               transcript: Transcript, a: list[int],
               Cx: bytes, Cy: bytes, device=None) -> None:
        if gens.n != n or len(a) != n:
            raise ProofVerifyError("dot product (log): dimension mismatch")
        transcript.append_protocol_name(DotProductProofLog.PROTOCOL)
        transcript.append_point(b"Cx", Cx)
        transcript.append_point(b"Cy", Cy)
        transcript.append_scalar_vector(b"a", a)

        r = transcript.challenge_scalar(b"r")
        Q_scaled = gens.gens_1.G[0].mul(r)
        h_scaled = gens.gens_1.h

        Gamma = _decompress(Cx).add(_decompress(Cy).mul(r))
        g_hat, Gamma_hat, a_hat = self.bullet_reduction_proof.verify(
            n, a, transcript, Gamma, gens.gens_n.G, device)
        transcript.append_point(b"delta", self.delta)
        transcript.append_point(b"beta", self.beta)
        c = transcript.challenge_scalar(b"c")

        lhs = hri.encode(
            Gamma_hat.mul(c).add(_decompress(self.beta)).mul(a_hat)
            .add(_decompress(self.delta))
        )
        rhs = hri.encode(
            g_hat.add(Q_scaled.mul(a_hat)).mul(self.z1)
            .add(h_scaled.mul(self.z2))
        )
        if lhs != rhs:
            raise ProofVerifyError("dot product (log) proof failed")
