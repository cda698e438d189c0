"""Plain references, one module per configuration's `reference` key."""
