"""Hand-written Hopper kernels (``csrc/*.cu``), their ctypes build and
wrappers (``ops``), and the plain torch versions (``ref``)."""
