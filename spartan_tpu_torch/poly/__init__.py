"""poly subpackage."""
