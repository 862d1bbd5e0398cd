"""The full tunable-flag surface: typed, documented, validated.

Parity: quisk_conf_defaults.py (2,652 lines, 182 documented flags) and
configure.py's parser of its ``## name  label, type`` doc comments — the
reference exposes every tunable as a module-level name with a typed doc
header, renders them into the config GUI and ``defaults.html``, and lets a
user config file override any of them.  Here the same catalogue is a
declarative registry: each :class:`Flag` carries name, type, default,
choices and help; :class:`Flags` is a validating value set; a user config
file (plain Python, like the reference's ``quisk_conf.py``) can be loaded
with :func:`load_config_file`; and :func:`docs_markdown` renders the
defaults.html equivalent.

Flag names, types and defaults follow the reference so existing quisk
configs carry over; help text is condensed.  GUI-geometry flags are kept
for config-file compatibility even though this framework is headless —
the streaming frontend reads the display section.
"""

from __future__ import annotations

import dataclasses
from typing import Any

_BOOL = "boolean"
_INT = "integer"
_NUM = "number"
_TEXT = "text"
_DICT = "dict"
_LIST = "list"
_ICHOICE = "integer choice"
_TCHOICE = "text choice"
_RFILE = "rfile"
_KEYCODE = "keycode"

_PY_TYPES = {
    _BOOL: bool, _INT: int, _NUM: (int, float), _TEXT: str, _DICT: dict,
    _LIST: list, _ICHOICE: int, _TCHOICE: str, _RFILE: str,
    _KEYCODE: (int, type(None)),
}


@dataclasses.dataclass(frozen=True)
class Flag:
    name: str
    type: str
    default: Any
    help: str = ""
    choices: tuple = ()
    section: str = "general"

    def validate(self, value: Any) -> Any:
        want = _PY_TYPES[self.type]
        if self.type == _NUM and isinstance(value, int):
            value = float(value)
        if self.type in (_BOOL,) and isinstance(value, int) \
                and not isinstance(value, bool):
            value = bool(value)
        if not isinstance(value, want):
            raise TypeError(f"{self.name} expects {self.type}, "
                            f"got {type(value).__name__}")
        if self.choices and value not in self.choices:
            raise ValueError(f"{self.name} must be one of {self.choices}, "
                             f"got {value!r}")
        return value


REGISTRY: dict[str, Flag] = {}
_SECTION = "general"


def _sec(name: str) -> None:
    global _SECTION
    _SECTION = name


def _f(name: str, type_: str, default: Any, help_: str = "",
       choices: tuple = ()) -> None:
    REGISTRY[name] = Flag(name, type_, default, help_, choices, _SECTION)


# --------------------------------------------------------------- hardware
_sec("hardware")
_f("hardware_file_name", _RFILE, "", "hardware plugin (here: a registry "
   "key like 'hermes'/'hiqsdr'/'sdriq', or a path for custom plugins)")
_f("widgets_file_name", _RFILE, "", "optional extra-controls plugin")
_f("use_rx_udp", _ICHOICE, 0, "UDP sample source family: 0 none, "
   "1/2 HiQSDR, 10 Hermes", (0, 1, 2, 10, 17))
_f("use_sdriq", _ICHOICE, 0, "capture from an SDR-IQ serial device",
   (0, 1))
_f("use_soapy", _INT, 0, "capture through SoapySDR")
_f("invertSpectrum", _ICHOICE, 0, "invert the RF spectrum (IF stages "
   "that flip sidebands)", (0, 1))
_f("fixed_vfo_freq", _INT, 7056000, "VFO for radios with a fixed LO")
_f("fixed_tune_offset", _INT, 0, "when nonzero, keep the tune this far "
   "from the VFO and retune by moving the VFO")
_f("default_rf_gain", _INT, 0, "initial RF gain for radios with a gain "
   "control")

_sec("softrock")
_f("usb_vendor_id", _INT, 0x16c0, "USB vendor id of the control device")
_f("usb_product_id", _INT, 0x05dc, "USB product id")
_f("si570_i2c_address", _INT, 0x55, "I2C address of the Si570 oscillator")
_f("si570_direct_control", _BOOL, False, "program the Si570 registers "
   "directly instead of via firmware smooth-tune")
_f("si570_xtal_freq", _INT, 114285000, "Si570 crystal frequency in Hz")
_f("repeater_delay", _NUM, 0.25, "seconds to hold TX after PTT release "
   "on repeaters")

_sec("hiqsdr")
_f("rx_udp_ip", _TEXT, "192.168.2.196", "radio sample-stream IP")
_f("rx_udp_port", _INT, 0xBC77, "radio sample-stream UDP port")
_f("rx_udp_ip_netmask", _TEXT, "255.255.255.0", "netmask for the radio's "
   "subnet")
_f("tx_ip", _TEXT, "", "IP for transmit samples")
_f("tx_audio_port", _INT, 0, "UDP port for transmit audio")
_f("rx_udp_clock", _INT, 122880000, "ADC/DDC clock in Hz; sample rates "
   "divide this")
_f("sndp_active", _BOOL, True, "enable the simple network discovery "
   "protocol to set the radio's IP")
_f("HiQSDR_BandDict", _DICT, {}, "band -> IO-bus control byte")
_f("cw_delay", _INT, 0, "hardware CW key-down delay")

_sec("hermes")
_f("udp_rx_ip", _TEXT, "", "known Hermes IP (skip discovery broadcast)")
_f("hermes_code_version", _INT, -1, "reported firmware version")
_f("hermes_board_id", _INT, -1, "reported board id")
_f("hermes_lowpwr_tr_enable", _BOOL, False, "disable T/R relay in low "
   "power output")
_f("hermes_power_amp", _BOOL, False, "enable the power amplifier bit")
_f("power_meter_calib_name", _TCHOICE, "HL2FilterE3", "power-meter "
   "calibration table name")
_f("hermes_disable_sync", _BOOL, False, "disable power-supply sync")
_f("hermes_TxLNA_dB", _INT, -12, "LNA gain during transmit, dB")
_f("hermes_tx_buffer_latency", _INT, 10, "TX buffer latency, ms")
_f("hermes_PTT_hang_time", _INT, 4, "PTT hang time, ms")
_f("hermes_antenna_tuner", _TCHOICE, "None", "antenna tuner control",
   ("None", "Tune bypass", "Tune"))
_f("hermes_PWM", _TCHOICE, "Fan speed", "PWM output use",
   ("Fan speed", "PTT", "Off"))
_f("hermes_disable_watchdog", _BOOL, False, "disable the TX watchdog")
_f("hermes_reset_on_disconnect", _BOOL, False, "reset the radio when the "
   "network connection drops")
_f("hermes_bias_adjust", _BOOL, False, "enable PA bias adjustment")
_f("hermes_iob_rxin", _TCHOICE, "J10 available", "IO-board RX input "
   "routing", ("J10 available", "J10 to N2ADR", "J9 to N2ADR"))
_f("Hermes_BandDict", _DICT, {}, "band -> J16 filter-select bits")
_f("Hermes_BandDictTx", _DICT, {}, "band -> TX filter-select bits")
_f("Hermes_BandDictEnTx", _BOOL, False, "use separate TX band bits")
_f("Hware_Hl2_EepromIP", _TEXT, "192.168.1.6", "HL2 EEPROM fixed IP")
_f("Hware_Hl2_EepromIPUse", _TCHOICE, "Ignore", "how the HL2 uses the "
   "EEPROM IP", ("Ignore", "Use DHCP first", "Use IP always"))
_f("Hware_Hl2_EepromMAC", _TEXT, "0xA1 0x6B", "HL2 EEPROM MAC low bytes")
_f("Hware_Hl2_EepromMACUse", _TCHOICE, "Ignore", "whether to use the "
   "EEPROM MAC", ("Ignore", "Use MAC always"))
_f("calibrate_temp_20", _INT, 0, "temperature sensor calibration at 20C")
_f("calibrate_temp_40", _INT, 0, "temperature sensor calibration at 40C")
_f("calibrate_current_0", _INT, 0, "bias current calibration point 0")
_f("calibrate_current_1", _INT, 0, "bias current calibration point 1")

_sec("sdriq")
_f("sdriq_name", _TEXT, "/dev/ttyUSB0", "SDR-IQ serial device name")
_f("sdriq_clock", _NUM, 66666667.0, "SDR-IQ A/D clock in Hz")

_sec("remote-sound")
_f("radio_sound_ip", _TEXT, "", "IP of the remote sound server")
_f("radio_sound_port", _INT, 0, "UDP port for remote speaker audio")
_f("radio_sound_nsamples", _INT, 360, "samples per remote sound packet")
_f("radio_sound_mic_ip", _TEXT, "", "IP for remote microphone audio")
_f("radio_sound_mic_port", _INT, 0, "UDP port for remote mic audio")
_f("radio_sound_mic_nsamples", _INT, 720, "samples per remote mic packet")
_f("radio_sound_mic_boost", _BOOL, False, "add 10 dB mic gain at the "
   "remote end")
_f("remote_radio_ip", _TEXT, "", "IP of the remote-operated radio")
_f("remote_radio_password", _TEXT, "", "shared secret for remote control")
_f("IQ_Server_IP", _TEXT, "", "IP of an external I/Q sample server")

# ------------------------------------------------------------------ sound
_sec("sound")
_f("sample_rate", _INT, 48000, "hardware input I/Q sample rate, Hz")
_f("playback_rate", _ICHOICE, 48000, "radio sound playback rate",
   (0, 24000, 48000, 96000, 192000))
_f("channel_i", _INT, 0, "soundcard channel carrying I")
_f("channel_q", _INT, 1, "soundcard channel carrying Q")
_f("channel_delay", _INT, -1, "delay this channel one sample to fix "
   "swapped-sample soundcards; -1 off")
_f("tx_channel_delay", _INT, -1, "same correction on the TX side")
_f("lin_name_of_sound_capt", _TEXT, "hw:0", "capture device (Linux)")
_f("win_name_of_sound_capt", _TEXT, "Primary", "capture device (Windows)")
_f("lin_name_of_sound_play", _TEXT, "hw:0", "playback device (Linux)")
_f("win_name_of_sound_play", _TEXT, "Primary", "playback device (Windows)")
_f("lin_sample_playback_name", _TEXT, "", "device to replay raw I/Q to")
_f("win_sample_playback_name", _TEXT, "", "device to replay raw I/Q to")
_f("lin_latency_millisecs", _INT, 150, "playback buffer depth, ms")
_f("win_latency_millisecs", _INT, 150, "playback buffer depth, ms")
_f("lin_data_poll_usec", _INT, 5000, "sound polling interval, us")
_f("win_data_poll_usec", _INT, 20000, "sound polling interval, us")
_f("mic_sample_rate", _ICHOICE, 48000, "microphone capture rate",
   (8000, 48000))
_f("lin_microphone_name", _TEXT, "", "microphone device (Linux)")
_f("win_microphone_name", _TEXT, "", "microphone device (Windows)")
_f("mic_channel_I", _INT, 0, "mic channel used")
_f("mic_channel_Q", _INT, 0, "second mic channel (I/Q TX soundcards)")
_f("lin_name_of_mic_play", _TEXT, "", "TX I/Q output device (Linux)")
_f("win_name_of_mic_play", _TEXT, "", "TX I/Q output device (Windows)")
_f("mic_playback_rate", _INT, 48000, "TX I/Q output rate, Hz")
_f("mic_play_chan_I", _INT, 0, "TX output channel carrying I")
_f("mic_play_chan_Q", _INT, 1, "TX output channel carrying Q")
_f("lin_digital_input_name", _TEXT, "", "digital-mode audio input "
   "(loopback from WSJT-X etc.)")
_f("win_digital_input_name", _TEXT, "", "digital-mode audio input")
_f("lin_digital_output_name", _TEXT, "", "digital-mode audio output")
_f("win_digital_output_name", _TEXT, "", "digital-mode audio output")
_f("lin_digital_rx1_name", _TEXT, "", "sub-receiver 1 digital output")
_f("win_digital_rx1_name", _TEXT, "", "sub-receiver 1 digital output")
_f("digital_output_level", _NUM, 0.7, "digital output amplitude 0..1")
_f("file_play_level", _NUM, 1.0, "file playback amplitude 0..1")
_f("max_record_minutes", _NUM, 1.0, "length of the record buffer")
_f("use_fast_sound", _BOOL, False, "lower-latency sound path when the "
   "backend supports it")
_f("pulse_audio_verbose_output", _INT, 0, "PulseAudio debug verbosity")

# --------------------------------------------------------------------- rx
_sec("rx")
_f("agc_max_gain", _NUM, 15000.0, "AGC maximum gain (slider top)")
_f("agc_release_time", _NUM, 1.0, "AGC release time constant, seconds")
_f("correct_smeter", _NUM, 15.5, "S-meter calibration offset, dB")
_f("dc_remove_bw", _INT, 100, "DC-removal highpass bandwidth, Hz; 0 off")
_f("add_extern_demod", _TEXT, "", "name of an external demodulator "
   "button/module")
_f("rx_max_amplitude_correct", _NUM, 0.2, "range of the I/Q amplitude "
   "balance control")
_f("rx_max_phase_correct", _NUM, 10.0, "range of the I/Q phase balance "
   "control, degrees")
_f("freq_spacing", _INT, 0, "snap tuning to this channel spacing, Hz")
_f("freq_round_ssb", _INT, 0, "round SSB tuning to this step, Hz")
_f("freq_base", _INT, 0, "base frequency the spacing is relative to")

# --------------------------------------------------------------------- tx
_sec("tx")
_f("tx_level", _DICT, {}, "band -> TX output level percent")
_f("digital_tx_level", _INT, 100, "max TX power percent in digital modes")
_f("modulation_index", _NUM, 1.67, "FM modulation index")
_f("reverse_tx_sideband", _INT, 0, "swap the transmitted sideband")
_f("do_repeater_offset", _BOOL, False, "apply repeater TX offsets from "
   "the band plan")
_f("spot_button_keys_tx", _BOOL, True, "the Spot button keys the "
   "transmitter")
_f("add_imd_button", _ICHOICE, 0, "show a two-tone IMD test button",
   (0, 1))
_f("add_fdx_button", _ICHOICE, 0, "allow full-duplex operation", (0, 1))
_f("maximum_tx_secs", _INT, 0, "TX watchdog timeout, seconds; 0 off")
_f("TxRxSilenceMsec", _INT, 50, "mute this long after TX->RX switch, ms")

_sec("keyer")
_f("cwTone", _INT, 600, "CW sidetone/pitch, Hz")
_f("use_sidetone", _ICHOICE, 0, "generate a local CW sidetone", (0, 1))
_f("start_cw_delay", _INT, 15, "delay from key-down to RF in CW, ms")
_f("start_ssb_delay", _INT, 100, "mute this long at the start of an SSB "
   "transmission, ms")
_f("keyupDelay", _INT, 500, "hold TX this long after key-up, ms")
_f("lin_quisk_serial_port", _TEXT, "", "serial port polled for a CW key "
   "and PTT (Linux)")
_f("win_quisk_serial_port", _TEXT, "", "serial port polled for CW/PTT "
   "(Windows)")
# choice strings are the reference's exact config values
# (quisk_conf_defaults.py:1878-1891) so existing configs load, and
# SerialKey._parse's '"when low"' polarity test matches them
_f("quisk_serial_cts", _TCHOICE, "None", "what the CTS line signals",
   ("None", "CW", "PTT", "CW when high", "CW when low",
    "PTT when high", "PTT when low"))
_f("quisk_serial_dsr", _TCHOICE, "None", "what the DSR line signals",
   ("None", "CW", "PTT", "CW when high", "CW when low",
    "PTT when high", "PTT when low"))
_f("hot_key_ptt1", _KEYCODE, None, "PTT hot key code")
_f("hot_key_ptt2", _KEYCODE, None, "PTT hot key modifier")
_f("hot_key_ptt_toggle", _BOOL, False, "hot key toggles PTT instead of "
   "push-to-hold")
_f("hot_key_ptt_if_hidden", _BOOL, False, "hot key works when the app is "
   "hidden")
_f("midi_cwkey_device", _TEXT, "", "MIDI device used as a CW key")
_f("midi_cwkey_note", _INT, -1, "MIDI note number acting as the key")
_f("midi_ptt_toggle", _BOOL, False, "MIDI PTT toggles instead of holds")

# ------------------------------------------------------------------- cat
_sec("cat")
_f("tci_ip", _TEXT, "127.0.0.1", "TCI server bind address")
_f("tci_port", _INT, 0, "TCI server port; 0 disables")
_f("hamlib_ip", _TEXT, "", "rigctl server bind address; '' localhost")
_f("hamlib_port", _INT, 4532, "rigctl server port; 0 disables")
_f("digital_xmlrpc_url", _TEXT, "http://localhost:7362",
   "fldigi XML-RPC endpoint")
_f("lin_hamlib_com1_name", _TEXT, "", "serial CAT port 1 (Linux)")
_f("lin_hamlib_com2_name", _TEXT, "", "serial CAT port 2 (Linux)")
_f("win_hamlib_com1_name", _TEXT, "", "serial CAT port 1 (Windows)")
_f("win_hamlib_com2_name", _TEXT, "", "serial CAT port 2 (Windows)")
_f("k4_tcp_ip", _TEXT, "", "Elecraft K4 protocol server IP")
_f("k4_tcp_port", _INT, 0, "Elecraft K4 protocol port; 0 disables")
_f("dxClHost", _TEXT, "", "DX cluster telnet host")
_f("dxClPort", _INT, 7373, "DX cluster telnet port")
_f("user_call_sign", _TEXT, "", "call sign sent to the DX cluster")
_f("dxClPassword", _TEXT, "", "DX cluster password")
_f("dxClExpireTime", _INT, 20, "minutes until DX spots expire")
_f("favorites_file_path", _TEXT, "", "path of the favorites table file")

# --------------------------------------------------------------- display
_sec("display")
_f("graph_refresh", _INT, 7, "graph updates per second")
_f("graph_window", _TEXT, "hann", "spectrum analysis window",
   choices=("rect", "hann", "hamming", "blackman", "blackman-harris",
            "flat-top"))
_f("fft_size_multiplier", _INT, 0, "FFT size as a multiple of the data "
   "width; 0 = auto")
_f("graph_overlap", _NUM, 0.0, "analysis-frame overlap fraction (0, 0.5,"
   " 0.75) — wdsp analyzer overlapped capture",
   choices=(0.0, 0.5, 0.75))
_f("graph_peak_hold_1", _NUM, 0.25, "peak-hold decay for button 1")
_f("graph_peak_hold_2", _NUM, 0.10, "peak-hold decay for button 2")
_f("graph_width", _NUM, 0.8, "graph width as a fraction of the screen")
_f("display_fraction", _NUM, 1.0, "fraction of the sample bandwidth "
   "displayed")
_f("station_display_lines", _INT, 1, "rows of station labels under the "
   "frequency scale")
_f("default_screen", _TCHOICE, "Graph", "screen shown at startup",
   ("Graph", "GraphP1", "GraphP2", "WFall", "Scope", "RX Filter",
    "Bscope"))
_f("waterfall_palette", _TCHOICE, "A", "waterfall color palette",
   ("A", "B", "C"))
_f("color_scheme", _TCHOICE, "A", "UI color scheme", ("A", "B", "C"))
_f("use_unicode_symbols", _BOOL, True, "unicode symbols on buttons")
_f("decorate_buttons", _BOOL, True, "draw button decorations")
_f("button_layout", _TCHOICE, "Large screen", "control layout",
   ("Large screen", "Small screen"))
_f("window_width", _INT, -1, "main window width; -1 auto")
_f("window_height", _INT, -1, "main window height; -1 auto")
_f("window_posX", _INT, -1, "main window x position; -1 auto")
_f("window_posY", _INT, -1, "main window y position; -1 auto")
_f("button_font_size", _INT, 10, "font size, buttons")
_f("default_font_size", _INT, 12, "font size, default")
_f("status_font_size", _INT, 14, "font size, status line")
_f("config_font_size", _INT, 14, "font size, config screens")
_f("graph_font_size", _INT, 10, "font size, graph labels")
_f("graph_msg_font_size", _INT, 14, "font size, graph messages")
_f("favorites_font_size", _INT, 14, "font size, favorites table")
_f("lin_quisk_typeface", _TEXT, "", "UI typeface (Linux)")
_f("win_quisk_typeface", _TEXT, "", "UI typeface (Windows)")

# ----------------------------------------------------------------- bands
_sec("bands")
_f("BandEdge", _DICT, {
    "137k": (135700, 137800), "500k": (472000, 479000),
    "160": (1800000, 2000000), "80": (3500000, 4000000),
    "60": (5300000, 5430000), "40": (7000000, 7300000),
    "30": (10100000, 10150000), "20": (14000000, 14350000),
    "17": (18068000, 18168000), "15": (21000000, 21450000),
    "12": (24890000, 24990000), "10": (28000000, 29700000),
    "6": (50000000, 54000000), "4": (70000000, 70500000),
    "2": (144000000, 148000000), "1.25": (222000000, 225000000),
    "70cm": (420000000, 450000000), "33cm": (902000000, 928000000),
}, "band name -> (low, high) edge in Hz")
_f("bandLabels", _LIST,
   ["160", "80", "60", "40", "30", "20", "17", "15", "12", "10", "6",
    "2", "Time"], "band buttons shown, in order")
_f("bandTransverterOffset", _DICT, {}, "band -> transverter offset, Hz")


# ===================================================================== API
class Flags:
    """A validated value set over the registry.

    Attribute access returns the current value; :meth:`set` validates
    type and choices.  Unknown names raise KeyError (the reference warns
    about unknown config-file names the same way, configure.py)."""

    def __init__(self, **overrides: Any):
        object.__setattr__(self, "_values", {})
        for k, v in overrides.items():
            self.set(k, v)

    def __getattr__(self, name: str) -> Any:
        values = object.__getattribute__(self, "_values")
        if name in values:
            return values[name]
        try:
            return REGISTRY[name].default
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name: str, value: Any) -> None:
        self.set(name, value)

    def get(self, name: str) -> Any:
        return getattr(self, name)

    def set(self, name: str, value: Any) -> None:
        if name not in REGISTRY:
            raise KeyError(f"unknown flag {name!r}")
        self._values[name] = REGISTRY[name].validate(value)

    def overrides(self) -> dict[str, Any]:
        """Only the values that differ from defaults (what gets saved)."""
        return {k: v for k, v in self._values.items()
                if v != REGISTRY[k].default}

    def to_json(self) -> dict[str, Any]:
        return self.overrides()

    @classmethod
    def from_json(cls, d: dict[str, Any]) -> "Flags":
        out = cls()
        for k, v in d.items():
            if k in REGISTRY:       # tolerate renamed/removed flags
                fl = REGISTRY[k]
                if fl.type == _DICT and isinstance(v, dict):
                    # JSON round-trips tuples as lists
                    v = {kk: tuple(vv) if isinstance(vv, list) else vv
                         for kk, vv in v.items()}
                out.set(k, v)
        return out


def platform_flag(flags: Flags, name: str, platform: str = "lin") -> Any:
    """Resolve a lin_/win_ flag pair (the reference prefixes every
    OS-specific name, configure.py platform handling)."""
    return flags.get(f"{platform}_{name}")


def load_config_file(path: str, flags: Flags | None = None,
                     strict: bool = False) -> tuple[Flags, list[str]]:
    """Execute a user config file (reference ``quisk_conf.py`` semantics:
    plain Python assigning flag names) and fold known names into a Flags
    set.  Returns (flags, unknown_names)."""
    flags = flags or Flags()
    ns: dict[str, Any] = {}
    with open(path) as f:
        exec(compile(f.read(), path, "exec"), ns)
    unknown = []
    for name, value in ns.items():
        if name.startswith("_") or callable(value) or \
                isinstance(value, type(dataclasses)):
            continue
        if name in REGISTRY:
            flags.set(name, value)
        else:
            unknown.append(name)
    if strict and unknown:
        raise KeyError(f"unknown config names: {unknown}")
    return flags, unknown


def sections() -> list[str]:
    seen: list[str] = []
    for fl in REGISTRY.values():
        if fl.section not in seen:
            seen.append(fl.section)
    return seen


def docs_markdown() -> str:
    """Render the full flag catalogue (defaults.html parity)."""
    lines = ["# Configuration flags", ""]
    for sec in sections():
        lines.append(f"## {sec}")
        lines.append("")
        lines.append("| flag | type | default | help |")
        lines.append("|---|---|---|---|")
        for fl in REGISTRY.values():
            if fl.section != sec:
                continue
            d = repr(fl.default)
            if len(d) > 40:
                d = d[:37] + "..."
            extra = f" (choices: {fl.choices})" if fl.choices else ""
            lines.append(f"| `{fl.name}` | {fl.type} | `{d}` | "
                         f"{fl.help}{extra} |")
        lines.append("")
    return "\n".join(lines)
