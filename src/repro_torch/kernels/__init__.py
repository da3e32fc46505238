"""kernels of the PyTorch/CUDA port (see the package docstring): the
fused classical-receiver kernels (:mod:`.rx_fused`), the LDPC decoder
(:mod:`.ldpc`), the TE GEMM and its quantized form (:mod:`.te_gemm`),
flash attention and its quantized form (:mod:`.mha`), fused FC + softmax
(:mod:`.fc_softmax`) and the depthwise-separable conv block
(:mod:`.dwconv_block`), each a hand-written CUDA kernel beside its plain
twin.  :mod:`.ops` holds their public wrappers, :mod:`.ref` the plain
oracles, and :mod:`.tune` the autotuner whose cached winners the kernels'
launch pickers read before their static heuristics."""
from repro_torch.kernels import ops, ref, rx_fused, tune
from repro_torch.kernels.te_gemm import pick_block_shape
