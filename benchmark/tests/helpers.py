"""Tiny proofs of the port on the CPU, made once per protocol."""

from functools import lru_cache
from types import SimpleNamespace as NS

SEED = 2**31 + 77


def tiny(protocol: str) -> dict:
    return dict(protocol=protocol, num_cons=64, num_vars=64, num_inputs=10,
                nnz_per_matrix=64, circuit_seed=SEED)


@lru_cache(maxsize=None)
def prove(protocol: str):
    """Proofs of requests 0 and 1 of a 2^6 circuit: (circuit, the
    protocol's adapter, its deployment, proof bytes, inputs, other
    inputs, the second proof)."""
    from benchmark.circuit import Circuit
    from benchmark.loop import PROTOCOLS, _port, _tape_seed

    conf = tiny(protocol)
    port = _port()
    c = Circuit(64, 64, 10, SEED)
    inst = port.api.Instance.new(64, 64, 10, *c.entries(), device="cpu")
    proto = PROTOCOLS[protocol](port, conf, "cpu")
    dep = proto.encode(inst)
    blobs = []
    for k in range(2):
        inputs = c.inputs(SEED, k)
        blobs.append(proto.prove(dep, c.witness(inputs), inputs,
                                 _tape_seed(SEED, k)))
        proto.verify(dep, blobs[-1], inputs)
    return NS(protocol=protocol, circuit=c, proto=proto, dep=dep,
              blob=blobs[0], inputs=c.inputs(SEED, 0), other=c.inputs(SEED, 1),
              second=(blobs[1], c.inputs(SEED, 1)))


def ref_check(p, samples, cache_dir=None):
    from benchmark import check
    from benchmark.loop import LABEL

    return check.judge(p.protocol, [(p.circuit, p.dep.setup, samples)],
                       LABEL, SEED, cache_dir)
