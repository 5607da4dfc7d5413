"""Interactive preview server (port of pbrlab_tpu.app.viewer): the
reference GUI re-imagined for a headless GPU host.

The reference runs three threads: a progressive render loop applying
queued edits between passes, a buffer-update thread converting the
accumulator to sRGB, and a GLFW/ImGui window with a per-parameter
material editor (pc/pbrlab-gui.cc:129-274,
pc/glfw-window.cc:651-980, EditQueue pc/pc-common.h:14-81). A GPU host
has no GL surface, so the equivalent is an HTTP server any browser can
open:

* GET  /            live view: the running average as PNG, refreshed,
                    plus a material editor built from /materials
* GET  /image.png   current sRGB frame (`io.image.encode_png`)
* GET  /status      {pass, max_pass, pass_seconds}
* GET  /materials   {name: {param: value}} for every editable parameter
* POST /edit        {"material": m, "param": p, "value": v} -> EditQueue
* POST /replace     {"material": m, "kind": 0|1, "params": {...}}:
                    whole-material replacement incl. the type switch
                    (glfw-window.cc:960-975)
* POST /rerender    cancel + reset accumulation (RequestRerender)

The render loop stays in the caller's thread (render_loop()); the HTTP
server runs in daemon threads. Edits are applied between passes as the
reference does (ProgressiveRenderer._apply_edits) and reset the
accumulator (glfw-window.cc:621-625).
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

import numpy as np

_PAGE = """<!doctype html>
<html><head><title>pbrlab_tpu_torch preview</title><style>
body{font-family:sans-serif;background:#222;color:#ddd;margin:1em}
img{image-rendering:pixelated;border:1px solid #555}
.row{display:flex;gap:2em}input{width:14em}
td{padding:1px 6px}</style></head><body>
<h3>pbrlab_tpu_torch progressive preview</h3>
<div class=row><div>
<img id=view width=512><br><span id=stat></span>
<button onclick="fetch('/rerender',{method:'POST'})">Rerender</button>
</div><div id=editor></div></div>
<script>
async function tick(){
  const s = await (await fetch('/status')).json();
  document.getElementById('stat').textContent =
    `pass ${s.pass}/${s.max_pass}  (${(s.pass_seconds||0).toFixed(2)} s/pass)`;
  document.getElementById('view').src = '/image.png?t=' + Date.now();
}
async function buildEditor(){
  const m = await (await fetch('/materials')).json();
  let h = '';
  for (const [name, params] of Object.entries(m)) {
    const kind = params['kind'] ?? 0;
    h += `<h4>${name}</h4>
      <select id="${name}.__type">
        <option value=0 ${kind==0?'selected':''}>cycles_principled_bsdf</option>
        <option value=1 ${kind==1?'selected':''}>hair_bsdf</option>
      </select>
      <button onclick="replaceMat('${name}')">switch type / reset</button>
      <table>`;
    for (const [p, v] of Object.entries(params)) {
      if (p === 'kind') continue;
      const val = JSON.stringify(v);
      h += `<tr><td>${p}</td><td><input id="${name}.${p}" value='${val}'>
            <button onclick="edit('${name}','${p}')">set</button></td></tr>`;
    }
    h += '</table>';
  }
  document.getElementById('editor').innerHTML = h;
}
async function edit(m, p){
  const v = JSON.parse(document.getElementById(m + '.' + p).value);
  await fetch('/edit', {method:'POST',
    body: JSON.stringify({material:m, param:p, value:v})});
}
async function replaceMat(m){
  const kind = parseInt(document.getElementById(m + '.__type').value);
  await fetch('/replace', {method:'POST',
    body: JSON.stringify({material:m, kind:kind, params:{}})});
  setTimeout(buildEditor, 500);
}
buildEditor(); setInterval(tick, 1000); tick();
</script></body></html>"""


class PreviewServer:
    """HTTP preview + editor around a ProgressiveRenderer."""

    def __init__(self, renderer, max_pass: int = 512,
                 editable: Optional[List[str]] = None):
        self.r = renderer
        self.max_pass = max_pass
        self.editable = editable or [
            "kind", "base_color", "roughness", "specular", "metallic",
            "subsurface", "subsurface_radius", "subsurface_color",
            "hair_base_color", "melanin", "melanin_redness",
            "hair_roughness", "azimuthal_roughness", "shift"]
        self._png = b""
        self._lock = threading.Lock()
        self._stop = False
        self._server: Optional[ThreadingHTTPServer] = None
        self._update_png(self.r.average())

    # -- frame encoding (buffer-updater thread analogue) ------------------
    def _update_png(self, linear_img: np.ndarray) -> None:
        from ..io.image import encode_png, linear_to_srgb

        img8 = (np.clip(linear_to_srgb(np.clip(linear_img, 0.0, 1.0)), 0, 1)
                * 255.0 + 0.5).astype(np.uint8)
        png = encode_png(img8)
        with self._lock:
            self._png = png

    def materials_dict(self) -> Dict:
        mats = self.r.scene["materials"]
        out = {}
        for i, name in enumerate(self.r.material_names):
            params = {}
            for p in self.editable:
                if p not in mats:
                    continue
                col = mats[p].cpu().numpy()
                params[p] = (col[i].tolist() if col.ndim > 1
                             else float(col[i]))
            out[name] = params
        return out

    # -- HTTP --------------------------------------------------------------
    def start(self, port: int = 8520, host: str = "127.0.0.1") -> int:
        srv = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code, body, ctype):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path.startswith("/image.png"):
                    with srv._lock:
                        png = srv._png
                    self._send(200, png, "image/png")
                elif self.path.startswith("/status"):
                    body = json.dumps({
                        "pass": srv.r.num_passes,
                        "max_pass": srv.max_pass,
                        "pass_seconds": (srv.r.pass_times[-1]
                                         if srv.r.pass_times else None),
                    }).encode()
                    self._send(200, body, "application/json")
                elif self.path.startswith("/materials"):
                    self._send(200, json.dumps(srv.materials_dict()).encode(),
                               "application/json")
                else:
                    self._send(200, _PAGE.encode(), "text/html")

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0) or 0)
                payload = self.rfile.read(n) if n else b"{}"
                if self.path.startswith("/edit"):
                    e = json.loads(payload)
                    srv.r.queue_edit(e["material"], e["param"], e["value"])
                    self._send(200, b"{}", "application/json")
                elif self.path.startswith("/replace"):
                    # whole-material replacement incl. type switch
                    # (glfw-window.cc:960-975 / pc-common.h EditQueue
                    # MaterialParameter payload)
                    e = json.loads(payload)
                    srv.r.queue_material_replace(
                        e["material"], int(e["kind"]), e.get("params"))
                    self._send(200, b"{}", "application/json")
                elif self.path.startswith("/rerender"):
                    srv.r.rerender()
                    self._send(200, b"{}", "application/json")
                else:
                    self._send(404, b"{}", "application/json")

        self._server = ThreadingHTTPServer((host, port), Handler)
        t = threading.Thread(target=self._server.serve_forever, daemon=True)
        t.start()
        return self._server.server_address[1]

    def stop(self) -> None:
        self._stop = True
        if self._server is not None:
            self._server.shutdown()

    # -- render loop (reference render thread, pbrlab-gui.cc:207-222) -----
    def render_loop(self, dump_dir: Optional[str] = None) -> np.ndarray:
        """Render until max_pass (edits may reset the pass counter);
        optionally dump each pass average as PNG into dump_dir."""
        def on_pass(i, avg):
            self._update_png(avg)
            if dump_dir is not None:
                from ..render.film import save_png

                save_png(f"{dump_dir}/pass_{i:04d}.png", avg)

        img = self.r.render_until(self.max_pass,
                                  cancel=lambda: self._stop,
                                  on_pass=on_pass)
        return img
