"""The verify kernel's yardstick: the work one ed25519 verify needs, the
card's peaks, and the share of the roofline a traced window reached.

The operation count is frozen from the port's `chip_smoke.py` (commit
8db80e4, `FE_MUL_PER_VERIFY` .. `IN_BYTES_PER_VERIFY`), with its
derivation: 32x32->64 products per verify in the kernel's radix 2^25.5,
1,811 field multiplies (100 products each) and 1,550 squarings (55 each),
counted from `csrc/ed25519_verify.cu` as it stood: two decompressions
(19 mul + 255 sq each), -A and its folded T (2 mul), the table of v(-A)
(4 doublings with T, 3 adds, 8 T folds: 40 mul + 16 sq), 64 ladder
windows (20 mul + 16 sq each, plus one T on the last), 64 Niels adds
(7 mul each) and the final compare (2 mul). The count does not depend on
the data, and it stays the yardstick whatever kernel implements verify.

Peaks: Hopper issues 64 32-bit integer multiply-adds per clock per SM
(half its 128 FP32 lanes; one IMAD.WIDE counted as one, which makes the
bound a floor), at the card's maximum SM clock; HBM at 3.35 TB/s (the
H100 SXM data sheet). The card's power limit is printed beside them.
"""

from __future__ import annotations

import subprocess
from typing import Optional, Tuple

FE_MUL_PER_VERIFY = 2 * 19 + 2 + 40 + 64 * 20 + 1 + 64 * 7 + 2
FE_SQ_PER_VERIFY = 2 * 255 + 16 + 64 * 16
PRODUCTS_PER_VERIFY = 100 * FE_MUL_PER_VERIFY + 55 * FE_SQ_PER_VERIFY
# inputs (limbs, signs, nibbles as int32) and the output byte
IN_BYTES_PER_VERIFY = 4 * (20 + 1 + 20 + 1 + 64 + 64) + 1
# the kernel's parameter block, read once a launch
PARAM_BYTES = 4 * 64 * 9 * 3 * 10 + 4 * 30
IMAD_PER_CLOCK_PER_SM = 64
HBM_BYTES_PER_S = 3.35e12
KERNEL = "ed25519_verify"


def nvidia_smi(query: str) -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=" + query,
                        "--format=csv,noheader,nounits"],
                       capture_output=True, text=True, timeout=30)
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 and \
        r.stdout.strip() else ""


def card() -> dict:
    """SM count, maximum SM clock (Hz) and power limit (W) of card 0."""
    import torch
    out = {"sms": torch.cuda.get_device_properties(0).multi_processor_count}
    clk = nvidia_smi("clocks.max.sm")
    out["clock_hz"] = float(clk) * 1e6 if clk else None
    pw = nvidia_smi("power.limit")
    out["power_limit_w"] = float(pw) if pw else None
    return out


def verify_bound_s(sigs: int, launches: int, props: dict
                   ) -> Tuple[float, str]:
    """The least time `sigs` real verifies take on the card, and which
    bound sets it ("operations" or "bytes")."""
    ops_s = sigs * PRODUCTS_PER_VERIFY / (
        props["sms"] * IMAD_PER_CLOCK_PER_SM * props["clock_hz"])
    bytes_s = (sigs * IN_BYTES_PER_VERIFY + launches * PARAM_BYTES) \
        / HBM_BYTES_PER_S
    return (ops_s, "operations") if ops_s >= bytes_s else (bytes_s, "bytes")


def verify_roofline_pct(sigs: int, trace, props: Optional[dict]
                        ) -> Optional[float]:
    """The kernel's share of its roofline over a traced window: the bound
    of the real signatures it decided over its device time. None where
    nothing was traced or no kernel ran."""
    if trace is None or props is None or not props.get("clock_hz") \
            or sigs <= 0:
        return None
    kernel_s, launches = trace.kernel_time(KERNEL)
    if kernel_s <= 0 or launches == 0:
        return None
    bound_s, _by = verify_bound_s(sigs, launches, props)
    return 100.0 * bound_s / kernel_s
