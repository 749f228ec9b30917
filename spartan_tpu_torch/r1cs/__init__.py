"""r1cs subpackage."""
