"""ff subpackage."""
