"""The port's training engine and loop (the bsp plan)."""
