"""What a configuration file says, read the same way by the harness (to
build the program and its input) and by the reference (to work out the
answers): tuning, modes, listened channels.  Plain Python and NumPy."""

from __future__ import annotations

import numpy as np

FAMILY = {"USB": "ssb", "LSB": "ssb", "CWU": "ssb", "CWL": "ssb",
          "AM": "am", "FM": "fm"}


def rx_tunes(cfg: dict) -> np.ndarray:
    """Channel c's dial: ``first_hz + c * step_hz`` (float64)."""
    t = cfg["tune"]
    C = cfg["chain"]["channels"]
    return t["first_hz"] + np.arange(C, dtype=np.float64) * t["step_hz"]


def rx_modes(cfg: dict) -> list[str]:
    """Channel c's mode: the configuration's cycle, repeated."""
    cyc = cfg["modes"]["cycle"]
    return [cyc[c % len(cyc)] for c in range(cfg["chain"]["channels"])]


def pfb_modes(cfg: dict) -> list[str]:
    """Channel c's mode: the configuration's list laid over equal runs of
    channels (``by_run``; four modes over K channels are its quarters)."""
    runs = cfg["modes"]["by_run"]
    K = cfg["pipeline"]["n_chan"]
    return [runs[(len(runs) * c) // K] for c in range(K)]


def listened(cfg: dict, seed: int, count: int | None = None) -> np.ndarray:
    """The listened channels, drawn from the seed: ``count`` (by default
    the configuration's ``listen_channels``) spread equally over the mode
    runs, so every seed listens to the same mix of modes.  Sorted."""
    K = cfg["pipeline"]["n_chan"]
    n = cfg["listen_channels"] if count is None else count
    runs = len(cfg["modes"]["by_run"])
    if n % runs or n // runs > K // runs:
        raise ValueError(f"{n} listened channels do not split over {runs} "
                         f"mode runs of {K // runs}")
    rng = np.random.default_rng([seed, 1])
    picks = [r * (K // runs) + rng.choice(K // runs, n // runs, replace=False)
             for r in range(runs)]
    return np.sort(np.concatenate(picks))
