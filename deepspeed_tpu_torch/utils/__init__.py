"""Host-side helpers shared by the port's serving code."""
