"""The benchmark's machinery: set-up, the closed-loop clients, the trace
reduction, the work counts and the comparison that decides ``correct``."""
