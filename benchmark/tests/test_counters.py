"""The work counters against counts worked out by hand, and the scan's
least bytes against the port's bench expression."""

import torch
import torch.nn.functional as F

from benchmark.counters import scan_bytes
from benchmark.counters.flops import matmul_flops


def test_products_and_convolutions_by_hand():
    x = torch.empty(3, 5, 16, device="meta")
    w = torch.empty(32, 16, device="meta")
    assert matmul_flops(lambda: F.linear(x, w)) == 2 * 15 * 32 * 16
    img = torch.empty(2, 4, 10, 12, device="meta")
    k = torch.empty(8, 4, 3, 3, device="meta")
    # stride 2, padding 1: a 5 × 6 output
    assert matmul_flops(lambda: F.conv2d(img, k, stride=2, padding=1)) == \
        2 * (2 * 8 * 5 * 6) * 4 * 9
    # depthwise: nothing
    dw = torch.empty(4, 1, 3, 3, device="meta")
    assert matmul_flops(lambda: F.conv2d(img, dw, padding=1, groups=4)) == 0
    a = torch.empty(2, 7, 4, 6, device="meta")
    b = torch.empty(4, 3, 6, device="meta")
    assert matmul_flops(lambda: torch.einsum("blkd,kcd->blkc", a, b)) == 2 * 2 * 7 * 4 * 6 * 3


def test_convolution_backward_by_hand():
    img = torch.empty(2, 4, 10, 12, device="meta", requires_grad=True)
    k = torch.empty(8, 4, 3, 3, device="meta", requires_grad=True)
    fwd = 2 * (2 * 8 * 10 * 12) * 4 * 9

    def weight_grad_only():
        y = F.conv2d(img.detach(), k, padding=1)
        torch.autograd.grad(y.sum(), [k])

    def both():
        y = F.conv2d(img, k, padding=1)
        torch.autograd.grad(y.sum(), [img, k])

    assert matmul_flops(weight_grad_only) == 2 * fwd
    assert matmul_flops(both) == 3 * fwd


def test_scan_bytes_by_hand():
    b, l, kd, n = 2, 1024, 128, 1
    c = scan_bytes.call_bytes(b, l, kd, n, itemsize=2)
    kd_pass, k_pass, params = b * l * kd * 2, b * l * 4 * n * 2, (kd * n + 2 * kd) * 4
    assert c == {"fwd": 3 * kd_pass + 2 * k_pass + params,
                 "bwd": 5 * kd_pass + 4 * k_pass + 2 * params}
    assert scan_bytes.total_bytes([(b, l, kd, n)] * 3, 2, backward=True) == \
        3 * (c["fwd"] + c["bwd"])


def test_scan_bytes_against_the_port_bench():
    """The port's bench counts a chained call: the same passes plus the
    chain's read of y (forward) or of du and the ones written as dy
    (backward), and H0, but not the three parameter vectors."""
    from vm_asr_tpu_torch.bench import scan_roofline_bytes
    from vm_asr_tpu_torch.ops.selective_scan_fused import chunk_length

    b, l, kd = 8, 16384, 128
    port = scan_roofline_bytes(b, l, kd)
    h0 = b * (-(-l // chunk_length(b, l, kd))) * kd * 4
    kd_pass = b * l * kd * 2
    ours = scan_bytes.call_bytes(b, l, kd, 1, 2)
    params = (kd + 2 * kd) * 4
    assert port["fwd"] == ours["fwd"] - params + kd_pass + h0
    assert port["fwd_bwd"] == ours["fwd"] + ours["bwd"] - 3 * params + 2 * kd_pass + 2 * h0


def test_scan_itemsize_follows_the_configuration():
    cfg = {"AMP_ENABLE": True, "DTYPE": {"COMPUTE": "bfloat16"}, "MODEL": {"VSSM": {}}}
    assert scan_bytes.scan_itemsize(cfg) == 2
    cfg["MODEL"]["VSSM"]["SCAN_FP32_IO"] = True
    assert scan_bytes.scan_itemsize(cfg) == 4
