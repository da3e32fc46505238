"""kernels of the PyTorch/CUDA port (see the package docstring): the
fused classical-receiver kernels (:mod:`.rx_fused`), the LDPC decoder
(:mod:`.ldpc`), the TE GEMM (:mod:`.te_gemm`) and flash attention
(:mod:`.mha`), each a hand-written CUDA kernel beside its plain twin."""
