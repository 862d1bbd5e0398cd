"""Wideband raw-IQ capture source: the ingest front door of the PFB
channelizer receiver.

The reference's sample sources are its radios' protocols, each
packet-rate-bound at ~1-1.4 KB/frame (quisk.c:3284/3519) — fine for the
radios' own 48-384 kHz streams, far under what a card demodulating
thousands of channels can eat.  This plugin is the framework-native
source with no reference analogue BY DESIGN: a jumbo-frame raw-iq24 UDP
stream (io/native.WidebandStream, native codec 2, 48 KB datagrams)
feeding one or more wideband captures into the PFB channelizer.  Its
rates on a given host are measured, not assumed (``chip_smoke.py``).

``n_streams > 1`` aggregates one socket + one native reader thread per
stream via :class:`~quisk_tpu_torch.io.pump.MultiPump`; ``read_samples``
returns ``[n_streams, n]`` blocks.  ``read_samples(n, out=slot)`` pops
straight into a caller's buffer, e.g. ``DeviceFeed.push_into``'s pinned
slot.
"""

from __future__ import annotations

from quisk_tpu_torch.hw.base import Hardware, register_hardware


@register_hardware("wideband")
class WidebandHardware(Hardware):
    """Raw wideband UDP capture(s) -> blocks for the PFB channelizer."""

    def __init__(self, conf=None, n_streams: int = 1,
                 sample_rate: float = 61_440_000.0, striped: bool = False):
        """``striped=True`` treats the N sockets as ONE capture striped
        round-robin by the sender (packet seq % N -> socket i): blocks
        come back as [1, n] in capture order — how a single wideband
        stream exceeds the one-socket rate.  ``striped=False``
        aggregates N INDEPENDENT captures as [N, n]."""
        super().__init__(conf)
        self.n_streams = int(n_streams)
        self.sample_rate = float(sample_rate)
        self.striped = bool(striped)
        self.pump = None

    def start_pump(self, port: int = 0, host: str = "127.0.0.1",
                   block: int = 0):
        """Bind the ingest socket(s); returns the list of (host, port)
        addresses senders should stream wideband frames to.  ``port``
        applies to the single-stream case only — multiple streams need
        distinct sockets and always bind ephemeral ports.  ``block`` is
        the most samples one ``read_samples`` will ask for: each ring
        holds at least two such blocks (a PFB block of 2^25 samples is 32
        times the default ring, which could never fill it)."""
        from quisk_tpu_torch.io import native
        from quisk_tpu_torch.io.pump import MultiPump, StripedPump, make_pump

        if self.n_streams == 1:
            self.pump = make_pump("wideband", n_rx=1, port=port, host=host,
                                  ring_samples=max(1 << 20, 2 * block))
            self.pump.start()
            return [self.pump.local_addr]
        if self.striped:
            # one logical capture over N sockets (native-only: the
            # per-socket seq expectations live in the C++ pump)
            self.pump = StripedPump(
                n_sockets=self.n_streams, host=host,
                ring_samples=max(1 << 22, 2 * block // self.n_streams))
            self.pump.start()
            return list(self.pump.local_addrs)
        # native=False path falls back to UdpPump+WidebandStream per
        # socket (review finding: the native default raised on hosts
        # without the built library instead of degrading like make_pump)
        self.pump = MultiPump("wideband", n_pumps=self.n_streams,
                              n_rx=1, host=host,
                              ring_samples=max(1 << 20, 2 * block),
                              native=native.have_native_pump())
        self.pump.start()
        return list(self.pump.local_addrs)

    def read_samples(self, n: int, out=None):
        if self.pump is None:
            return None
        return self.pump.read_samples(n, out=out)

    def open(self) -> str:
        self.status_text = (f"wideband capture x{self.n_streams} @ "
                            f"{self.sample_rate / 1e6:.3f} MHz")
        return self.status_text

    def close(self) -> None:
        if self.pump is not None:
            self.pump.stop()
            if hasattr(self.pump, "close"):
                self.pump.close()
            self.pump = None
