"""What the readers of ``moonlight-16b-a3b``'s per-layer metrics share."""

from __future__ import annotations

from typing import Optional

from benchmark import arith_moonlight
from benchmark.trace import kernel_seconds


def mla_flash_roofline(run, kinds) -> Optional[float]:
    """Percent: the bound of the traced launches of the flash kernels
    ``kinds`` (``"fwd"``, ``"dq"``, ``"dkv"``) at latent attention's true
    head dims over their device time; None off the card, on an untraced
    run, or for a model without latent attention."""
    ts = run.traces()
    if run.kind != "train" or ts is None or not run.on_card \
            or "qk_nope" not in run.model:
        return None
    t = run.traffic
    bounds = arith_moonlight.flash_bounds_ms(run.model, t["rows"], t["seq"])
    need, took = 0.0, 0.0
    for tr in ts:
        for k in kinds:
            sec, n = kernel_seconds(tr["by_name"], "flash_" + {
                "fwd": "fwd", "dq": "bwd_dq", "dkv": "bwd_dkv"}[k])
            need += n * bounds[k] / 1e3
            took += sec
    return 100.0 * need / took if took > 0 else None
