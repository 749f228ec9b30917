"""curve subpackage."""
