"""Streaming web frontend — the GUI surface without wx.

The reference's user surface is a wxPython app: GraphScreen
(quisk.py:2094) draws the averaged spectrum, WaterfallScreen
(quisk.py:2889) the scrolling palette rows, mode buttons
(quisk.py:5061-5088) and the frequency display drive retunes.  The plan
(SURVEY §7 M5) replaces that with "an optional streaming server in lieu
of the wx GUI": this module serves a single-page canvas UI over HTTP and
streams spectrum rows + radio state over a WebSocket (the same
from-scratch RFC 6455 layer as the TCI server, quisk_tpu_torch/app/tci.py),
accepting tune/mode/sub-RX commands back.

Protocol (one WebSocket, path ``/ws``):

- server -> client, binary: ``b'S'`` + pad[3] + f64 start_hz + f64
  bin_hz + f32 smeter_db + float32[n] spectrum dB row (channel 0, after
  the current zoom/pan window; 24-byte header so the row is 4-aligned
  for JS Float32Array views).
- server -> client, binary: ``b'M'`` + u8 channel + u16 pad + f64
  start_hz + f64 bin_hz + float32[n] — one narrow spectrum row per
  sub-receiver 1..255, centered on its tuned frequency
  (get_multirx_graph, quisk.c:4868); 20-byte aligned header.
- server -> client, text: JSON state ``{"freq": .., "vfo": .., "mode":
  .., "modes": [..], "channels": N, "subrx": [{channel, freq, mode,
  route}..], "keyed": bool, "tx": bool, "spot": f, "split": 0-4,
  "tx_freq": hz, "rit": hz, "rit_on": bool, "zoom": z,
  "zoom_center": hz|null}`` on connect and after any change.
- client -> server, text: JSON ``{"cmd": "freq", "value": hz}``,
  ``{"cmd": "mode", "value": "USB"}``, ``{"cmd": "subrx", "channel": c,
  "freq": hz, "mode": m, "route": r}``, ``{"cmd": "ptt", "value":
  bool}``, ``{"cmd": "spot", "value": level}``, ``{"cmd": "split",
  "value": bool, "tx_freq": hz?, "play": 1-4?}``, ``{"cmd": "tx_freq",
  "value": hz}``, ``{"cmd": "rit", "value": hz, "on": bool?}``,
  ``{"cmd": "zoom",
  "value": z, "center": hz}`` (z >= 1; center pans the window).

The page renders the spectrum as a polyline and feeds the same rows into
a client-side waterfall using the identical palette breakpoints as
app/graph.py:waterfall_palette (quisk.c:5334's C renderer); sub-RX rows
render as small per-receiver panels with their own tune/mode/route
controls (the reference's multi-RX window row, quisk.py:2094 sub-graphs).
"""

from __future__ import annotations

import json
import socket
import socketserver
import struct
import threading

import numpy as np

from quisk_tpu_torch.app.tci import WsDecoder, _ws_accept_key, ws_encode

MODES = ["CWL", "CWU", "LSB", "USB", "AM", "FM",
         "DGT_U", "DGT_L", "DGT_FM", "DGT_IQ", "FDV_U", "FDV_L", "IMD"]

#: sub-RX rows a spectrum refresh streams: the 'M' frame's u8 channel
#: field names channels 1..255
MULTIRX_ROWS = 256

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>quisk_tpu</title><style>
 body{background:#111;color:#ddd;font:14px sans-serif;margin:12px}
 canvas{display:block;background:#000;margin-bottom:4px}
 button{margin:2px;background:#333;color:#ddd;border:1px solid #555}
 button.on{background:#2a6}
 input{background:#222;color:#ddd;border:1px solid #555;width:9em}
 #smeter{color:#6f6;margin-left:1em}
</style></head><body>
<div>
 <input id="freq" type="number" step="100"> Hz
 <button onclick="setFreq()">Tune</button>
 <span id="modes"></span>
 <span id="smeter"></span>
</div>
<div>
 <button id="ptt" onclick="togglePtt()">PTT</button>
 <button id="spot" onclick="toggleSpot()">Spot</button>
 <input id="spotlvl" type="number" step="0.1" min="0" max="1" value="0.5"
  style="width:4em">
 <button onclick="zoomBy(2)">Zoom+</button>
 <button onclick="zoomBy(0.5)">Zoom-</button>
 <button id="split" onclick="toggleSplit()">Split</button>
 <input id="txfreq" type="number" step="100" style="width:8em"
  onchange="send({cmd:'tx_freq',value:+this.value})">
 <button id="rit" onclick="toggleRit()">RIT</button>
 <input id="ritval" type="number" step="10" value="0" style="width:4em"
  onchange="send({cmd:'rit',value:+this.value,on:state.rit_on})">
 <button onclick="send({cmd:'mem_save'})">MemSave</button>
 <button onclick="send({cmd:'mem_next'})">MemNext</button>
 <button onclick="send({cmd:'mem_delete'})">MemDel</button>
 <span id="dspstages"></span>
 <span style="color:#888">(click spectrum to pan when zoomed)</span>
</div>
<canvas id="spec" width="1024" height="220"></canvas>
<canvas id="wf" width="1024" height="260"></canvas>
<div id="subrx"></div>
<script>
const spec=document.getElementById('spec'),wf=document.getElementById('wf');
const sctx=spec.getContext('2d'),wctx=wf.getContext('2d');
let state={},f0=0,df=1;
const MODES=%MODES%;
const mdiv=document.getElementById('modes');
for(const m of MODES){const b=document.createElement('button');
 b.textContent=m;b.id='m_'+m;b.onclick=()=>send({cmd:'mode',value:m});
 mdiv.appendChild(b);}
const ws=new WebSocket('ws://'+location.host+'/ws');
ws.binaryType='arraybuffer';
function send(o){ws.send(JSON.stringify(o));}
function setFreq(){send({cmd:'freq',value:+document.getElementById('freq').value});}
// palette breakpoints match quisk_tpu/app/graph.py waterfall_palette
const BP=[[0,0,0,0],[1/6,0,0,160],[2/6,0,160,160],[3/6,0,200,0],
          [4/6,230,230,0],[5/6,240,0,0],[1,255,255,255]];
function pal(t){t=Math.min(1,Math.max(0,t));
 for(let i=1;i<BP.length;i++){if(t<=BP[i][0]){const a=BP[i-1],b=BP[i];
  const u=(t-a[0])/(b[0]-a[0]);
  return [a[1]+u*(b[1]-a[1]),a[2]+u*(b[2]-a[2]),a[3]+u*(b[3]-a[3])];}}
 return [255,0,0];}
function togglePtt(){send({cmd:'ptt',value:!state.keyed});}
function toggleSplit(){send({cmd:'split',value:!state.split});}
function toggleRit(){send({cmd:'rit',
 value:+document.getElementById('ritval').value,on:!state.rit_on});}
function toggleSpot(){
 const lvl=+document.getElementById('spotlvl').value;
 send({cmd:'spot',value:(state.spot>=0)?-1:lvl});}
function zoomBy(k){
 const z=Math.max(1,Math.min(1024,(state.zoom||1)*k));
 send({cmd:'zoom',value:z,center:state.zoom_center});}
spec.onclick=(ev)=>{
 const fx=f0+df*(ev.offsetX*1024/spec.clientWidth);
 // top strip = station markers row: click tunes to the nearest station
 // (StationScreen OnLeftDown, quisk.py:2696)
 if(ev.offsetY*spec.height/spec.clientHeight<12&&state.stations&&
    state.stations.length){
  let best=null,bd=1e18;
  for(const st of state.stations){const d=Math.abs(st.freq-fx);
   if(d<bd){bd=d;best=st;}}
  if(best&&bd<Math.abs(df)*40){
   if(best.mode&&MODES.includes(best.mode.toUpperCase()))
    send({cmd:'mode',value:best.mode.toUpperCase()});
   send({cmd:'freq',value:best.freq});return;}}
 if((state.zoom||1)<=1)return;  // else pan: set the zoom window center
 send({cmd:'zoom',value:state.zoom,center:fx});};
function renderSubrx(){
 const div=document.getElementById('subrx');
 if(!state.subrx||!state.subrx.length){div.innerHTML='';return;}
 for(const s of state.subrx){
  let p=document.getElementById('sub_'+s.channel);
  if(!p){p=document.createElement('div');p.id='sub_'+s.channel;
   p.innerHTML='RX'+s.channel+' <input id="sf_'+s.channel+
    '" type="number" step="100" value="'+s.freq+'"> Hz '+
    '<select id="sm_'+s.channel+'">'+MODES.map(m=>'<option>'+m+
    '</option>').join('')+'</select> <select id="sr_'+s.channel+'">'+
    ['off','left','right','both'].map(r=>'<option>'+r+'</option>').join('')+
    '</select> <button>Set</button><br>'+
    '<canvas id="sc_'+s.channel+'" width="256" height="64"></canvas>';
   p.querySelector('button').onclick=()=>send({cmd:'subrx',
    channel:s.channel,freq:+document.getElementById('sf_'+s.channel).value,
    mode:document.getElementById('sm_'+s.channel).value,
    route:document.getElementById('sr_'+s.channel).value});
   div.appendChild(p);}
  document.getElementById('sm_'+s.channel).value=s.mode;
  document.getElementById('sr_'+s.channel).value=s.route;}}
ws.onmessage=(ev)=>{
 if(typeof ev.data==='string'){state=JSON.parse(ev.data);
  document.getElementById('freq').value=state.freq;
  for(const m of MODES)document.getElementById('m_'+m)
    .className=(m===state.mode)?'on':'';
  document.getElementById('ptt').className=state.keyed?'on':'';
  document.getElementById('spot').className=(state.spot>=0)?'on':'';
  document.getElementById('split').className=state.split?'on':'';
  document.getElementById('rit').className=state.rit_on?'on':'';
  document.getElementById('txfreq').value=state.tx_freq;
  // DSP stage buttons (NB/Notch/NR2/AGC/Sqlch): rendered from the
  // chain's actual optional stages, toggled live as data
  const sd=document.getElementById('dspstages');
  const SN={nb:'NB',notch:'Notch',nr:'NR2',anf:'ANF',agc:'AGC',
            squelch:'Sqlch',fm_sq:'FMsq'};
  for(const k in (state.stages||{})){
   let b=document.getElementById('st_'+k);
   if(!b){b=document.createElement('button');b.id='st_'+k;
    b.textContent=SN[k]||k;
    b.onclick=()=>send({cmd:'stage',name:k,on:!state.stages[k]});
    sd.appendChild(b);}
   b.className=state.stages[k]?'on':'';}
  renderSubrx();
  return;}
 const dv=new DataView(ev.data);
 if(dv.getUint8(0)===77){                             // 'M' sub-RX row
  const ch=dv.getUint8(1);
  const c=document.getElementById('sc_'+ch);
  if(!c)return;
  const n=(ev.data.byteLength-20)/4;
  const r=new Float32Array(ev.data,20,n);
  const cx=c.getContext('2d');
  cx.fillStyle='#000';cx.fillRect(0,0,c.width,c.height);
  cx.strokeStyle='#fa4';cx.beginPath();
  for(let i=0;i<n;i++){const x=i*c.width/n;
   const y=c.height*(1-(r[i]+140)/140);
   i?cx.lineTo(x,y):cx.moveTo(x,y);}
  cx.stroke();return;}
 if(dv.getUint8(0)!==83)return;                       // 'S'
 f0=dv.getFloat64(4,true);df=dv.getFloat64(12,true);
 const sm=dv.getFloat32(20,true);
 document.getElementById('smeter').textContent='S-meter '+sm.toFixed(1)+' dB';
 const n=(ev.data.byteLength-24)/4;
 const row=new Float32Array(ev.data,24,n);
 // spectrum polyline, -140..0 dB
 sctx.fillStyle='#000';sctx.fillRect(0,0,spec.width,spec.height);
 sctx.strokeStyle='#4c4';sctx.beginPath();
 for(let i=0;i<n;i++){const x=i*spec.width/n;
  const y=spec.height*(1-(row[i]+140)/140);
  i?sctx.lineTo(x,y):sctx.moveTo(x,y);}
 sctx.stroke();
 // station markers row (StationScreen): fav=yellow, mem=cyan, dx=pink
 if(state.stations)for(const st of state.stations){
  const x=(st.freq-f0)/df*spec.width/n;
  if(x<0||x>spec.width)continue;
  sctx.fillStyle={fav:'#fd4',mem:'#4dd',dx:'#f6a'}[st.kind]||'#fff';
  sctx.fillRect(x,0,1,8);
  sctx.font='10px sans-serif';
  sctx.fillText(st.name||st.mode||'',x+2,10);}
 // waterfall scroll
 wctx.drawImage(wf,0,0,wf.width,wf.height-1,0,1,wf.width,wf.height-1);
 const img=wctx.createImageData(wf.width,1);
 for(let x=0;x<wf.width;x++){const v=row[Math.floor(x*n/wf.width)];
  const c=pal((v+140)/110);
  img.data[4*x]=c[0];img.data[4*x+1]=c[1];img.data[4*x+2]=c[2];
  img.data[4*x+3]=255;}
 wctx.putImageData(img,0,0);
};
</script></body></html>
""".replace("%MODES%", json.dumps(MODES))


class _Handler(socketserver.StreamRequestHandler):
    """One HTTP connection: serves the page, or upgrades to WebSocket."""

    def handle(self):
        srv: WebUIServer = self.server.ui          # type: ignore[attr-defined]
        try:
            head = b""
            while b"\r\n\r\n" not in head:
                chunk = self.request.recv(4096)
                if not chunk:
                    return
                head += chunk
            req, _, rest = head.partition(b"\r\n\r\n")
            lines = req.decode("latin1").split("\r\n")
            path = lines[0].split()[1] if len(lines[0].split()) > 1 else "/"
            hdrs = {}
            for ln in lines[1:]:
                if ":" in ln:
                    k, v = ln.split(":", 1)
                    hdrs[k.strip().lower()] = v.strip()
            if path == "/ws" and "websocket" in hdrs.get("upgrade", "").lower():
                accept = _ws_accept_key(hdrs.get("sec-websocket-key", ""))
                self.request.sendall(
                    b"HTTP/1.1 101 Switching Protocols\r\n"
                    b"Upgrade: websocket\r\nConnection: Upgrade\r\n"
                    b"Sec-WebSocket-Accept: " + accept.encode() + b"\r\n\r\n")
                self._ws_loop(srv, rest)
                return
            if path.startswith("/flags"):
                # the runtime config surface (configure.py:543-588): full
                # registry + per-radio values; edits go over the WS as
                # {"cmd": "flag", "name": ..., "value": ...}
                sec = None
                if "?section=" in path:
                    sec = path.split("?section=", 1)[1]
                fd = (srv.control.flags_dict(section=sec)
                      if hasattr(srv.control, "flags_dict") else {})
                body = json.dumps(fd).encode()
                ctype = b"application/json"
            else:
                body = _PAGE.encode()
                ctype = b"text/html"
            self.request.sendall(
                b"HTTP/1.1 200 OK\r\nContent-Type: " + ctype + b"\r\n"
                b"Content-Length: " + str(len(body)).encode()
                + b"\r\nConnection: close\r\n\r\n" + body)
        except (ConnectionError, OSError, ValueError):
            pass

    def _ws_loop(self, srv: "WebUIServer", rest: bytes) -> None:
        dec = WsDecoder()
        srv.register(self)
        try:
            self.request.sendall(ws_encode(json.dumps(srv.state_dict())))
            frames = dec.feed(rest) if rest else []
            while not srv._stop.is_set():
                for op, payload in frames:
                    if op == 0x8:                   # close
                        return
                    if op == 0x9:                   # ping -> pong
                        self.request.sendall(ws_encode(payload, opcode=0xA))
                    elif op == 0x1:
                        srv.on_command(payload.decode("utf-8", "replace"))
                try:
                    data = self.request.recv(4096)
                except socket.timeout:
                    frames = []
                    continue
                if not data:
                    return
                frames = dec.feed(data)
        except (ConnectionError, OSError):
            pass
        finally:
            srv.unregister(self)

    def setup(self):
        super().setup()
        self.request.settimeout(0.2)


class WebUIServer:
    """HTTP + WebSocket GUI server around a control interface.

    ``control`` needs ``set_frequency(hz)``, ``set_mode(str)``, optionally
    ``set_sub_rx(...)``, and attributes ``freq_hz``/``vfo_hz``/``cfg.mode``
    — i.e. a :class:`quisk_tpu_torch.app.radio.Radio` (or a test double).
    """

    def __init__(self, control, host: str = "127.0.0.1", port: int = 0):
        self.control = control
        self._clients: list[_Handler] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        # zoom/pan window applied to streamed spectrum rows (the
        # reference's graph zoom, quisk.c:5194 graph zoom/deltaf)
        self.zoom = 1.0
        self.zoom_center: float | None = None

        class _Srv(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._srv = _Srv((host, port), _Handler)
        self._srv.ui = self                        # type: ignore[attr-defined]
        self.port = self._srv.server_address[1]
        self._thread: threading.Thread | None = None

    # ---- lifecycle ----
    def start(self) -> int:
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        kwargs={"poll_interval": 0.1},
                                        daemon=True)
        self._thread.start()
        return self.port

    def stop(self) -> None:
        self._stop.set()
        self._srv.shutdown()
        self._srv.server_close()
        if self._thread is not None:
            self._thread.join(timeout=2)

    # ---- client registry ----
    def register(self, h: _Handler) -> None:
        with self._lock:
            self._clients.append(h)

    def unregister(self, h: _Handler) -> None:
        with self._lock:
            if h in self._clients:
                self._clients.remove(h)

    @property
    def n_clients(self) -> int:
        with self._lock:
            return len(self._clients)

    def _broadcast(self, frame: bytes) -> None:
        with self._lock:
            clients = list(self._clients)
        for h in clients:
            try:
                h.request.sendall(frame)
            except (ConnectionError, OSError):
                self.unregister(h)

    # ---- app-facing API ----
    def widget_panel(self):
        """The headless widget tree (quisk_widgets.py semantics, see
        app/widgets.py) bound to this radio; built lazily, synced to the
        radio state before each serialization."""
        if getattr(self, "_widgets", None) is None:
            try:
                from quisk_tpu_torch.app.widgets import standard_panel
                self._widgets = standard_panel(self.control)
            except (AttributeError, TypeError):
                self._widgets = False    # a non-Radio control object
        return self._widgets or None

    def _widget_json(self) -> list:
        p = self.widget_panel()
        if p is None:
            return []
        c = self.control
        p["freq"].display(c.freq_hz)
        p["entry"].set_freq(int(c.freq_hz))
        p["mode"].set_label(c.cfg.mode)
        if getattr(c, "band", None):
            p["band"].set_label(c.band)
        p["Vol"].set_value(int(c.volume * 100))
        p["Mute"].set_value(c.muted)
        p["RIT"].set_value(int(c.rit_hz))
        p["Split"].set_index(int(getattr(c, "split_rxtx", 0)))
        p["PTT"].set_value(bool(getattr(c, "_keyed", False)))
        return p.to_json()

    def state_dict(self) -> dict:
        c = self.control
        nchan = getattr(getattr(c, "cfg", c), "channels", 1)
        subrx = []
        offs = getattr(c, "offsets", None)
        if offs is not None and nchan > 1:
            vfo = getattr(c, "vfo_hz", 0.0)
            cmodes = getattr(c, "channel_modes", ["USB"] * nchan)
            routes = getattr(c, "routes", ["off"] * nchan)
            subrx = [{"channel": ch, "freq": vfo + float(offs[ch]),
                      "mode": cmodes[ch], "route": routes[ch]}
                     for ch in range(1, nchan)]
        return {"freq": getattr(c, "freq_hz", 0.0),
                "vfo": getattr(c, "vfo_hz", 0.0),
                "mode": getattr(getattr(c, "cfg", c), "mode", "USB"),
                "modes": MODES,
                "channels": nchan,
                "volume": getattr(c, "volume", 1.0),
                "muted": getattr(c, "muted", False),
                "band": getattr(c, "band", None),
                "subrx": subrx,
                # TX surface: PTT indicator + Spot level (quisk.py PTT
                # button state / microphone.c:1218 spot carrier)
                "keyed": bool(getattr(c, "_keyed", False)),
                "tx": getattr(c, "tx", None) is not None,
                "spot": getattr(c, "spot_level", -1.0),
                # split RX/TX + RIT (quisk.py splitButton/ritButton row)
                "split": getattr(c, "split_rxtx", 0),
                "tx_freq": getattr(c, "tx_freq_hz",
                                   getattr(c, "freq_hz", 0.0)),
                "rit": getattr(c, "rit_hz", 0.0),
                "rit_on": getattr(c, "rit_on", False),
                "zoom": self.zoom,
                "zoom_center": self.zoom_center,
                # StationScreen rows (quisk.py:2598): favorites/memory/DX
                # markers drawn above the spectrum, click-to-tune
                "stations": (self.control.station_markers()
                             if hasattr(self.control, "station_markers")
                             else []),
                # runtime DSP stage toggles (NB/Notch/NR2/AGC/Sqlch
                # buttons): {stage: bool} for stages built into the chain
                "stages": (self.control.stage_states()
                           if hasattr(self.control, "stage_states")
                           else {}),
                # the widget-model tree (quisk_widgets.py equivalents);
                # frontends may render these instead of bespoke controls
                "widgets": self._widget_json()}

    def send_state(self) -> None:
        self._broadcast(ws_encode(json.dumps(self.state_dict())))

    def _zoom_window(self, start_hz: float, bin_hz: float,
                     row: np.ndarray) -> tuple[float, float, np.ndarray]:
        """Apply the current zoom/pan: slice the span around zoom_center
        and re-grid back to the display pixel count (quisk.c:5194 zoom)."""
        n = len(row)
        if self.zoom <= 1.0:
            return start_hz, bin_hz, row
        span = n / self.zoom
        f_center = (self.zoom_center if self.zoom_center is not None
                    else start_hz + 0.5 * n * bin_hz)
        lo = (f_center - start_hz) / bin_hz - span / 2.0
        lo = float(np.clip(lo, 0.0, n - span))
        xi = lo + np.arange(n) * (span / n)
        zoomed = np.interp(xi, np.arange(n), row).astype(np.float32)
        return start_hz + lo * bin_hz, bin_hz * span / n, zoomed

    def send_spectrum(self, start_hz: float, bin_hz: float,
                      db_row: np.ndarray, smeter_db: float = -140.0,
                      raw: bool = False) -> None:
        """Stream one channel-0 spectrum row (get_graph's dB pixels,
        quisk.c:5271-5326) to every connected page.  ``raw=True`` skips
        the pixel zoom window — the row already covers the view at its
        own (finer) resolution (Radio's ZoomSpectrum re-capture)."""
        row = np.asarray(db_row, np.float32)
        if not raw:
            start_hz, bin_hz, row = self._zoom_window(start_hz, bin_hz,
                                                      row)
        payload = (b"S" + struct.pack("<3xddf", float(start_hz),
                                      float(bin_hz), float(smeter_db))
                   + row.tobytes())
        self._broadcast(ws_encode(payload))

    def send_multirx(self, vfo_hz: float, sample_rate: float,
                     trace: np.ndarray, offsets, span_hz: float = 24000.0,
                     pixels: int = 256) -> None:
        """Stream one narrow row per sub-receiver: channel c's dB trace
        sliced to ``span_hz`` around its tuned frequency and re-gridded to
        ``pixels`` (the small per-sub-RX graphs of get_multirx_graph,
        quisk.c:4868 / quisk.py multi-RX window).  The frame names its
        channel in one byte, so sub-receivers 1..255 get a row; a radio
        with more channels streams those (the reference's struct.pack
        raised at channel 256, inside the radio's block loop)."""
        trace = np.asarray(trace, np.float32)
        n = trace.shape[-1]
        bin_hz = sample_rate / n
        f0 = vfo_hz - 0.5 * sample_rate
        for ch in range(1, min(trace.shape[0], MULTIRX_ROWS)):
            fc = vfo_hz + float(offsets[ch])
            lo = (fc - 0.5 * span_hz - f0) / bin_hz
            lo = float(np.clip(lo, 0.0, max(0.0, n - span_hz / bin_hz)))
            xi = lo + np.arange(pixels) * (span_hz / bin_hz / pixels)
            row = np.interp(xi, np.arange(n), trace[ch]).astype(np.float32)
            # header padded to 20 bytes so the f32 row lands 4-aligned
            # (JS Float32Array views require aligned byteOffset)
            payload = (b"M" + struct.pack("<BHdd", ch, 0, f0 + lo * bin_hz,
                                          span_hz / pixels) + row.tobytes())
            self._broadcast(ws_encode(payload))

    def on_command(self, text: str) -> None:
        try:
            msg = json.loads(text)
        except ValueError:
            return
        try:
            self._dispatch(msg)
        except (KeyError, TypeError, ValueError, IndexError, AttributeError):
            # malformed-but-valid-JSON command: drop it, keep the socket
            return

    def _dispatch(self, msg: dict) -> None:
        cmd = msg.get("cmd")
        if cmd == "freq":
            self.control.set_frequency(float(msg["value"]))
        elif cmd == "mode" and msg.get("value") in MODES:
            self.control.set_mode(msg["value"])
        elif cmd == "subrx" and hasattr(self.control, "set_sub_rx"):
            self.control.set_sub_rx(int(msg["channel"]),
                                    freq_hz=msg.get("freq"),
                                    mode=msg.get("mode"),
                                    route=msg.get("route"))
        elif cmd == "volume" and hasattr(self.control, "set_volume"):
            self.control.set_volume(float(msg["value"]))
        elif cmd == "mute" and hasattr(self.control, "set_mute"):
            self.control.set_mute(bool(msg["value"]))
        elif cmd == "band" and hasattr(self.control, "set_band"):
            self.control.set_band(str(msg["value"]))
        elif cmd == "ptt" and hasattr(self.control, "set_ptt"):
            self.control.set_ptt(bool(msg["value"]))
        elif cmd == "spot" and hasattr(self.control, "set_spot"):
            self.control.set_spot(float(msg["value"]))
        elif cmd == "split" and hasattr(self.control, "set_split"):
            self.control.set_split(bool(msg["value"]),
                                   tx_freq=msg.get("tx_freq"),
                                   play=int(msg.get("play", 1)))
        elif cmd == "tx_freq" and hasattr(self.control, "set_tx_frequency"):
            self.control.set_tx_frequency(float(msg["value"]))
        elif cmd == "rit" and hasattr(self.control, "set_rit"):
            self.control.set_rit(float(msg["value"]),
                                 on=msg.get("on"))
        elif cmd == "mem_save" and hasattr(self.control, "save_memory"):
            self.control.save_memory()
        elif cmd == "mem_next" and hasattr(self.control, "next_memory"):
            self.control.next_memory()
        elif cmd == "mem_delete" and hasattr(self.control, "delete_memory"):
            self.control.delete_memory()
        elif cmd == "mem_recall" and hasattr(self.control, "recall_memory"):
            self.control.recall_memory(float(msg["value"]))
        elif cmd == "stage" and hasattr(self.control, "set_stage"):
            try:
                self.control.set_stage(str(msg["name"]), bool(msg["on"]))
            except KeyError:
                return
        elif cmd == "nb_level" and hasattr(self.control, "set_nb_level"):
            self.control.set_nb_level(int(msg["value"]))
        elif cmd == "squelch_level" and hasattr(self.control,
                                                "set_squelch_level"):
            try:
                self.control.set_squelch_level(float(msg["value"]))
            except KeyError:
                return
        elif cmd == "agc_level" and hasattr(self.control, "set_agc_level"):
            try:
                self.control.set_agc_level(
                    max_gain_db=msg.get("max_gain_db"),
                    target=msg.get("target"))
            except KeyError:
                return
        elif cmd == "bandwidth" and hasattr(self.control, "set_bandwidth"):
            self.control.set_bandwidth(
                None if msg.get("value") is None else float(msg["value"]),
                channel=int(msg.get("channel", 0)))
        elif cmd == "fdx" and hasattr(self.control, "set_fdx"):
            self.control.set_fdx(bool(msg["value"]))
        elif cmd == "sidetone" and hasattr(self.control, "set_sidetone"):
            self.control.set_sidetone(float(msg["value"]))
        elif cmd == "widget":
            p = self.widget_panel()
            if p is None:
                return
            kw = {k: v for k, v in msg.items()
                  if k not in ("cmd", "id", "event")}
            if not p.dispatch(str(msg["id"]), str(msg["event"]), **kw):
                return
        elif cmd == "flag" and hasattr(self.control, "set_flag"):
            self.control.set_flag(str(msg["name"]), msg["value"])
        elif cmd == "zoom":
            z = float(msg["value"])
            if not 1.0 <= z <= 1024.0:
                raise ValueError("zoom out of range")
            self.zoom = z
            if msg.get("center") is not None:
                self.zoom_center = float(msg["center"])
            elif z <= 1.0:
                self.zoom_center = None
            if hasattr(self.control, "set_zoom"):
                # multi-resolution re-capture past the base FFT's
                # resolution (wdsp analyzer spans): the radio engages a
                # ZoomSpectrum and streams true finer-resolution rows
                self.control.set_zoom(z, self.zoom_center)
        else:
            return
        self.send_state()
