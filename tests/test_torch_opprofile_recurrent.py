"""repro_torch.analysis.opprofile's unsharded FLOPs against the
reference's HLO count for the hybrid, ssm and audio families (the
tolerance and the one differing product are stated in
test_torch_opprofile.py, which holds the other families)."""
import pytest

from test_torch_opprofile import check_flops
from _port_share import port_share  # noqa: F401


@pytest.mark.parametrize("arch", ["zamba2-7b", "rwkv6-1.6b", "whisper-tiny"])
def test_unsharded_flops_equal_the_reference_hlo(arch):
    check_flops(arch)
