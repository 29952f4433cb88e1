"""Analysis helpers of the port (the recompile sentinel)."""
