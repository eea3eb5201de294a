"""Hand-written CUDA kernels for Hopper (sources in ``repro_torch/csrc``),
each beside its plain torch version and a launch counter.  Modules import
no CUDA toolchain: the kernels build at first launch (``_build``)."""
