"""B1 (``csrc/row_msm.cu``) in the witness commitment: the least time
for the (L, R) witness rows and the L blinds, counted on the non-zero
4-bit digits of each proof's witness and blinds (``benchmark/bounds.py``),
over B1's device time inside the prove calls, in percent.  The NIZK's
prove runs B1 only there; the SNARK's also in Spark."""
from benchmark import bounds
from benchmark.reference.transcript import random_tape_scalars
from benchmark.readers import B1_KERNELS, roofline


def read(run):
    if run.protocol != "nizk" or run.trace is None:
        return None
    c = run.config
    nv = 1 << (max(c["num_vars"], c["num_inputs"] + 1) - 1).bit_length()
    ell = (nv - 1).bit_length()
    least = 0.0
    for r in run.traced:
        if "vars" not in r:  # a request that proved nothing
            continue
        vars_ = list(r["vars"]) + [0] * (nv - len(r["vars"]))
        le = b"".join(v.to_bytes(32, "little") for v in vars_)
        blinds = random_tape_scalars(r["tape"], b"poly_blinds",
                                     1 << (ell // 2))
        least += bounds.witness_commit_s(le, blinds, nv)
    return roofline(run, least, B1_KERNELS)
