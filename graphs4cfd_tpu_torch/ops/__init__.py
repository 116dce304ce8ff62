"""Host graph ops (numpy) and device ops with their CUDA kernels.

Importing this package builds nothing: the kernels are compiled on the
first call that gives them a CUDA tensor (``ops._build``).
"""
