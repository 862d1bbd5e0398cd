"""Receive chain: decimation planning, raw-IQ conditioning and chain
composition."""

from quisk_tpu_torch.rx.planner import DecimPlan, plan_decimation  # noqa: F401
from quisk_tpu_torch.rx.chain import RxChain, RxChainConfig  # noqa: F401
