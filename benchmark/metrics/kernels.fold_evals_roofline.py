"""B2 (``csrc/fold_evals.cu``): the least time of the rounds' work that
the proofs need at the instance's sizes (both sum-check phases, and for
the SNARK Spark's product layers; ``benchmark/bounds.py``) over B2's
device time inside the prove calls, in percent."""
from benchmark import bounds
from benchmark.readers import B2_KERNELS, roofline


def read(run):
    c = run.config
    cons = 1 << (c["num_cons"] - 1).bit_length()
    nv = 1 << (max(c["num_vars"], c["num_inputs"] + 1) - 1).bit_length()
    launches = bounds.sat_proof_launches(cons, nv)
    if run.protocol == "snark":
        launches += bounds.spark_launches(cons, nv, c["nnz_per_matrix"])
    return roofline(run, len(run.traced) * bounds.launches_s(launches),
                    B2_KERNELS)
