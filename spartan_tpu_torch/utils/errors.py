"""Error types (reference src/errors.rs).  Unlike the reference — whose
verifier can panic on malformed proofs via assert! (SURVEY.md §5) — every
verification failure here raises ProofVerifyError."""


class ProofVerifyError(Exception):
    """Proof verification failed (incl. point decompression failures)."""


class ProofDeserializeError(Exception):
    """Malformed proof byte stream (bincode-Err analogue): truncated,
    trailing bytes, non-canonical scalars, or absurd length prefixes."""


class R1CSError(Exception):
    """Invalid R1CS construction input."""

    NON_POWER_OF_TWO_CONS = "NonPowerOfTwoCons"
    NON_POWER_OF_TWO_VARS = "NonPowerOfTwoVars"
    INVALID_NUMBER_OF_INPUTS = "InvalidNumberOfInputs"
    INVALID_NUMBER_OF_VARS = "InvalidNumberOfVars"
    INVALID_SCALAR = "InvalidScalar"
    INVALID_INDEX = "InvalidIndex"

    def __init__(self, kind: str):
        self.kind = kind
        super().__init__(kind)
