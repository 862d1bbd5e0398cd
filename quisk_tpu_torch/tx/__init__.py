"""Transmit chain, EER polar split, PureSignal predistortion, PTT."""

from quisk_tpu_torch.tx.chain import TxChain, TxChainConfig  # noqa: F401
from quisk_tpu_torch.tx.eer import EERSplitter  # noqa: F401
from quisk_tpu_torch.tx.puresignal import (Predistorter,  # noqa: F401
                                           two_tone_imd_db)
