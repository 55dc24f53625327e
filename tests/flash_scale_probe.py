"""The flash forward's "scores x8, D=16, G=5, T=1000" row of
``chip_smoke.py`` phase 6 on two draws of its inputs: the one phase 6 holds
(its rows in table order) and the one it drew when a row at zamba2-1.2b's
training shape stood third in the table.  For each draw: the outputs beyond
phase 6's measure (more than one bf16 ulp and FLASH_BF16_ABS apart) for the
kernel against its plain version and for each against the f64 attention,
each one's largest |diff| from the f64 attention, and at every output where
kernel and plain version lie beyond the measure: the kernel's, the plain
version's and the f64 value, and sum_j p_j |v_j| in f64, the size of the
terms that the output cancels from.  Not a test: it needs one CUDA card,
prints what it measures and holds nothing.

    python3 tests/flash_scale_probe.py
"""
import math
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import FLASH_BF16_ABS, bf16_ulps, flash_f64, flash_inputs
from repro_torch.kernels import flash_attention as FA

#: The (A, Hq, Hkv, T, Tk, D) of the rows that phase 6 draws before the
#: scores-x8 row, in table order.
ROWS_BEFORE = [(4, 40, 8, 1024, 2048, 128), (4, 40, 8, 1024, 2048, 128),
               (3, 4, 2, 37, 64, 16), (2, 2, 2, 100, 300, 128),
               (2, 10, 2, 70, 130, 64), (1, 4, 2, 33, 57, 32),
               (2, 4, 2, 12, 32, 16), (2, 8, 2, 200, 200, 32),
               (1, 10, 2, 300, 300, 64), (2, 8, 2, 5, 105, 128),
               (2, 10, 2, 113, 150, 128)]
ZAMBA2_ROW = (1, 32, 32, 4096, 4096, 64)
X8_ROW = (1, 10, 2, 1000, 1000, 16)


def draw(before):
    g = torch.Generator(device="cuda").manual_seed(4321)
    for shape in before:
        flash_inputs(torch, g, *shape, torch.bfloat16, torch.bfloat16)
    return flash_inputs(torch, g, *X8_ROW, torch.bfloat16, torch.bfloat16)


def beyond(a, b):
    diff = (a.float() - b.float()).abs()
    return (bf16_ulps(torch, a, b) > 1) & (diff > FLASH_BF16_ABS)


def probe(label, q, k, v):
    scale = 8 / math.sqrt(16)
    kw = dict(causal=True, return_lse=True, softmax_scale=scale)
    o, _ = FA.flash_attention_fwd(q, k, v, **kw)
    wo, _ = FA.flash_attention_fwd_plain(q, k, v, **kw)
    o64, _ = flash_f64(torch, q, k, v, scale, True)
    w64, _ = flash_f64(torch, q, k, v.abs(), scale, True)  # sum_j p_j |v_j|
    exact = o64.to(torch.bfloat16)
    print(f"{label}: kernel vs plain version {int(beyond(o, wo).sum())} "
          f"outputs beyond, kernel vs f64 {int(beyond(o, exact).sum())}, "
          f"plain version vs f64 {int(beyond(wo, exact).sum())}; max |diff| "
          f"from f64: kernel {(o.double() - o64).abs().max().item():.3e}, "
          f"plain version {(wo.double() - o64).abs().max().item():.3e}",
          flush=True)
    for i in beyond(o, wo).nonzero().tolist():
        i = tuple(i)
        print(f"  at {list(i)}: kernel {o[i].item()!r}, plain "
              f"{wo[i].item()!r}, f64 {o64[i].item()!r}, sum p|v| "
              f"{w64[i].item():.6f}", flush=True)


def main():
    print(torch.cuda.get_device_name(0), flush=True)
    probe("phase 6's draw", *draw(ROWS_BEFORE))
    probe("with the zamba2-1.2b row third",
          *draw(ROWS_BEFORE[:2] + [ZAMBA2_ROW] + ROWS_BEFORE[2:]))


if __name__ == "__main__":
    main()
