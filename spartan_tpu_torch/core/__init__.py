"""Exact host-side crypto core: python-int fields, edwards/ristretto group,
keccak/STROBE/merlin transcripts.  Serves as (a) the differential-test
oracle for every TPU kernel and (b) the sequential Fiat-Shamir engine.
"""

from . import edwards, field, keccak, merlin, ristretto, strobe  # noqa: F401
