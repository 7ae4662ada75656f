"""Web dashboard: browser client for the gRPC master.

Counterpart of the JAX package's ``gui/app.py`` (the reference's desktop
main window and RPC workers: connect to a master, edit component
parameters, run tasks, watch signals live in scopes). A single-page browser
app (hand-written canvas scopes, no external assets) is served by a stdlib
HTTP server and bridged to the port's gRPC master
(``comm.MasterClient``) through a websocket that forwards ``performTask``
signals as they stream. Parameters are edited as YAML per config section
(``core/config.py``).

Run:  python -m control_box_rst_tpu_torch.gui --master localhost:50051 --port 8089
"""
from __future__ import annotations

import argparse
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

INDEX_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>corbo_tpu dashboard</title>
<style>
 body{font-family:system-ui,sans-serif;margin:0;background:#14161a;color:#e6e6e6}
 header{padding:8px 16px;background:#1d2026;display:flex;gap:12px;align-items:center}
 header h1{font-size:15px;margin:0;color:#9ecbff}
 button{background:#2b6cb0;color:#fff;border:0;border-radius:4px;padding:6px 12px;cursor:pointer}
 button:disabled{background:#444}
 #status{font-size:12px;color:#9ae6b4;white-space:pre-wrap}
 main{display:grid;grid-template-columns:330px 1fr;gap:10px;padding:10px}
 .panel{background:#1d2026;border-radius:6px;padding:10px}
 textarea{width:100%;min-height:72px;background:#0f1115;color:#d6deeb;border:1px solid #333;
          font-family:ui-monospace,monospace;font-size:11px;box-sizing:border-box}
 .sig{font-size:12px;margin:2px 0}
 canvas{background:#0f1115;border:1px solid #2a2d33;border-radius:4px;width:100%;height:170px}
 .scope{margin-bottom:10px}
 .scope .name{font-size:12px;color:#9ecbff;margin:2px 0}
 h2{font-size:12px;text-transform:uppercase;color:#888;margin:12px 0 4px}
</style></head><body>
<header><h1>corbo_tpu</h1>
 <button id="verify">verify config</button>
 <button id="run">perform task</button>
 <button id="stopb">stop</button>
 <span id="status">connecting…</span>
</header>
<main>
 <div class="panel" id="left">
  <h2>parameters</h2><div id="sections"></div>
  <h2>signals</h2><div id="sigtree"></div>
 </div>
 <div class="panel" id="scopes"></div>
</main>
<script>
const ws = new WebSocket(`ws://${location.hostname}:__WS_PORT__/`);
const S = {signals:{}, selected:new Set(), sections:{}};
const st = t => document.getElementById('status').textContent = t;
ws.onopen = () => { send({cmd:'ping'}); send({cmd:'sections'}); send({cmd:'available'}); };
ws.onclose = () => st('websocket closed');
function send(o){ ws.send(JSON.stringify(o)); }
ws.onmessage = ev => {
  const m = JSON.parse(ev.data);
  if (m.type==='status') st((m.ok?'✓ ':'✗ ')+(m.scope||'')+': '+m.text);
  else if (m.type==='sections') renderSections(m.sections);
  else if (m.type==='available') { for (const n in m.signals) if(!(n in S.signals)) S.signals[n]=null; renderTree(); }
  else if (m.type==='signal') { S.signals[m.name]={times:m.times, values:m.values, shape:m.shape, kind:m.kind};
                                if (S.selected.size===0 && m.kind==='time_series') S.selected.add(m.name);
                                renderTree(); drawAll(); }
  else if (m.type==='run_done') st('task done ('+m.count+' signals)');
};
function renderSections(sections){
  S.sections = sections;
  const d = document.getElementById('sections'); d.innerHTML='';
  for (const kind of ['task','controller','plant','observer']){
    const lbl = document.createElement('div'); lbl.className='sig'; lbl.textContent=kind;
    const ta = document.createElement('textarea'); ta.value = sections[kind]||''; ta.id='ta_'+kind;
    const b = document.createElement('button'); b.textContent='apply '+kind; b.style.margin='2px 0 8px';
    b.onclick = () => send({cmd:'set_section', kind, yaml:ta.value});
    d.append(lbl, ta, b);
  }
}
function renderTree(){
  const d = document.getElementById('sigtree'); d.innerHTML='';
  Object.keys(S.signals).sort().forEach(n => {
    const row = document.createElement('div'); row.className='sig';
    const cb = document.createElement('input'); cb.type='checkbox'; cb.checked=S.selected.has(n);
    cb.onchange = () => { cb.checked?S.selected.add(n):S.selected.delete(n); drawAll(); };
    row.append(cb, document.createTextNode(' '+n+(S.signals[n]?'':' (pending)')));
    d.append(row);
  });
}
function drawAll(){
  const d = document.getElementById('scopes'); d.innerHTML='';
  [...S.selected].sort().forEach(name => {
    const sig = S.signals[name]; if(!sig) return;
    const w = document.createElement('div'); w.className='scope';
    const lab = document.createElement('div'); lab.className='name'; lab.textContent=name;
    const cv = document.createElement('canvas'); w.append(lab, cv); d.append(w);
    drawScope(cv, sig);
  });
}
function drawScope(cv, sig){
  const W = cv.width = cv.clientWidth*2, H = cv.height = 340;
  const g = cv.getContext('2d'); g.clearRect(0,0,W,H);
  let vals = sig.values, T = sig.times;
  // values arrive flat with shape; reshape to [T][D]
  const shape = sig.shape && sig.shape.length ? sig.shape : [vals.length, 1];
  const rows = shape[0], cols = Math.max(1, Math.round(vals.length/Math.max(1,rows)));
  const series = [];
  for (let dI=0; dI<cols; dI++){ const s=[]; for(let r=0;r<rows;r++) s.push(vals[r*cols+dI]); series.push(s); }
  const t = (T && T.length===rows) ? T : [...Array(rows).keys()];
  const finite = series.flat().filter(Number.isFinite);
  if (!finite.length) return;
  const ymin = Math.min(...finite), ymax = Math.max(...finite), pad=(ymax-ymin)||1;
  const x0=45, y0=12, x1=W-8, y1=H-22;
  const X = v => x0 + (x1-x0)*(v-t[0])/((t[rows-1]-t[0])||1);
  const Y = v => y1 - (y1-y0)*(v-ymin+0.06*pad)/(1.12*pad);
  g.strokeStyle='#2a2d33'; g.strokeRect(x0,y0,x1-x0,y1-y0);
  g.fillStyle='#8a8f98'; g.font='18px monospace';
  g.fillText(ymax.toPrecision(3), 2, y0+14); g.fillText(ymin.toPrecision(3), 2, y1);
  g.fillText(t[0].toPrecision(3), x0, H-4); g.fillText(t[rows-1].toPrecision(3), x1-60, H-4);
  const colors=['#63b3ed','#f6ad55','#9ae6b4','#fc8181','#d6bcfa','#faf089'];
  series.forEach((s,dI)=>{ g.strokeStyle=colors[dI%colors.length]; g.lineWidth=2; g.beginPath();
    s.forEach((v,i)=>{ const px=X(t[i]), py=Y(v); i?g.lineTo(px,py):g.moveTo(px,py); }); g.stroke(); });
}
document.getElementById('verify').onclick = () => send({cmd:'verify'});
document.getElementById('run').onclick = () => { S.signals={}; S.selected=new Set(); send({cmd:'run'}); st('running…'); };
document.getElementById('stopb').onclick = () => send({cmd:'stop'});
</script></body></html>
"""


class DashboardServer:
    """HTTP (page) + websocket (master bridge) servers on two ports."""

    def __init__(self, master_address: str = "localhost:50051",
                 http_port: int = 8089, ws_port: Optional[int] = None,
                 host: str = "localhost"):
        self.master_address = master_address
        self.host = host
        self.http_port = http_port
        self.ws_port = ws_port if ws_port is not None else http_port + 1
        self._httpd = None
        self._ws_server = None
        self._threads = []

    # -- websocket bridge ---------------------------------------------------
    def _handle_ws(self, ws) -> None:
        from control_box_rst_tpu_torch.comm import MasterClient
        from control_box_rst_tpu_torch.comm.service import proto_to_signal

        client = MasterClient(self.master_address)
        try:
            for raw in ws:
                try:
                    msg = json.loads(raw)
                except json.JSONDecodeError:
                    ws.send(json.dumps(
                        {"type": "status", "ok": False, "text": "bad JSON"}))
                    continue
                cmd = msg.get("cmd")
                if cmd == "ping":
                    ok = client.ping()
                    ws.send(json.dumps({
                        "type": "status", "scope": "master", "ok": ok,
                        "text": self.master_address if ok else
                        f"master unreachable at {self.master_address}"}))
                elif cmd == "sections":
                    import yaml as _yaml

                    sections = {
                        k: _yaml.safe_dump(client.get_section(k))
                        for k in ("plant", "controller", "observer", "task")
                    }
                    ws.send(json.dumps({"type": "sections", "sections": sections}))
                elif cmd == "set_section":
                    import yaml as _yaml

                    kind = msg.get("kind", "")
                    try:
                        frag = _yaml.safe_load(msg.get("yaml", "")) or {}
                        setter = {
                            "plant": client.set_plant,
                            "controller": client.set_controller,
                            "observer": client.set_observer,
                            "task": client.set_task,
                        }[kind]
                        stt = setter(frag)
                        ok, text = stt.ok, stt.text
                    except Exception as e:
                        ok, text = False, f"{type(e).__name__}: {e}"
                    ws.send(json.dumps(
                        {"type": "status", "scope": kind, "ok": ok, "text": text}))
                elif cmd == "verify":
                    ok, text = client.verify_config()
                    ws.send(json.dumps(
                        {"type": "status", "scope": "verify", "ok": ok, "text": text}))
                elif cmd == "available":
                    ws.send(json.dumps(
                        {"type": "available", "signals": client.available_signals()}))
                elif cmd == "run":
                    count = 0
                    try:
                        for proto in client.perform_task_stream():
                            name, sig = proto_to_signal(proto)
                            payload = {
                                "type": "signal", "name": name,
                                "kind": sig["kind"],
                                "shape": list(proto.header.shape),
                                "times": list(proto.times),
                                "values": list(proto.values),
                            }
                            ws.send(json.dumps(payload))
                            count += 1
                    except Exception as e:
                        ws.send(json.dumps({"type": "status", "scope": "run",
                                            "ok": False, "text": str(e)}))
                    ws.send(json.dumps({"type": "run_done", "count": count}))
                elif cmd == "stop":
                    client.stop()
                    ws.send(json.dumps({"type": "status", "scope": "stop",
                                        "ok": True, "text": "stop requested"}))
                else:
                    ws.send(json.dumps({"type": "status", "ok": False,
                                        "text": f"unknown cmd {cmd!r}"}))
        finally:
            client.close()

    # -- lifecycle ------------------------------------------------------------
    def start(self) -> None:
        from websockets.sync.server import serve as ws_serve

        html = INDEX_HTML.replace("__WS_PORT__", str(self.ws_port))

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (stdlib API)
                body = html.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):
                pass

        self._httpd = ThreadingHTTPServer((self.host, self.http_port), Handler)
        self.http_port = self._httpd.server_address[1]
        t1 = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        t1.start()

        self._ws_server = ws_serve(self._handle_ws, self.host, self.ws_port)
        t2 = threading.Thread(target=self._ws_server.serve_forever, daemon=True)
        t2.start()
        self._threads = [t1, t2]

    def stop(self) -> None:
        if self._httpd:
            self._httpd.shutdown()
        if self._ws_server:
            self._ws_server.shutdown()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="corbo_tpu web dashboard")
    p.add_argument("--master", default="localhost:50051",
                   help="gRPC master address")
    p.add_argument("--port", type=int, default=8089, help="HTTP port")
    p.add_argument("--ws-port", type=int, default=None,
                   help="websocket port (default: HTTP port + 1)")
    p.add_argument("--host", default="localhost")
    args = p.parse_args(argv)
    srv = DashboardServer(args.master, args.port, args.ws_port, args.host)
    srv.start()
    print(f"dashboard: http://{args.host}:{srv.http_port}  "
          f"(master {args.master}, ws :{srv.ws_port})")
    try:
        for t in srv._threads:
            t.join()
    except KeyboardInterrupt:
        srv.stop()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
