"""The benchmark's plain reference: a Spartan verifier in Python integers.

It judges the proofs that the timed path produced.  It is written from
the protocol (microsoft/Spartan's ``r1csproof.rs``, ``sparse_mlpoly.rs``,
``product_tree.rs``, ``nizk/``, ``transcript.rs``, RFC 9496 for
ristretto255, merlin's STROBE-128 on Keccak-f[1600]) and imports nothing
but the standard library and numpy: no JAX, no JAX package, nothing of
the port.  It derives its own generators, its own Spark dense
representation and its own instance evaluations from the instance that
the benchmark built.
"""
