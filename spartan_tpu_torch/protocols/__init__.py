"""protocols subpackage."""
