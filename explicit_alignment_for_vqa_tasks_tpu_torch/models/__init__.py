"""Models of the port: T5/T0, the mapping networks and VC-T0."""
