"""Weight and state conversion."""
