"""Interactive browser viewer, the GLUT window's replacement.

The PyTorch counterpart of the JAX package's ``render/viewer.py``. The
reference's interactive path is a GLUT window fed by CUDA-GL PBO interop
with mouse-drag rotate/pan/zoom and keyboard shortcuts
(src/main.cpp:130-205, 283-353, 480-519). Here a small stdlib
``http.server`` renders frames on demand for a canvas page with the same
controls (left-drag rotate, wheel zoom, shift-drag pan, space = save frame,
f = advance animation frame, p = continuous playback, q = camera dump).

``/frame`` renders through ``Renderer.render_frame_interactive`` (the
deferred fast-path check, the u32 frame fetched), ``/save`` through the
synchronous ``render_frame``. The HUD's rolling FPS is the reference's
window-title counter (computeFPS, src/main.cpp:111-128); ``/camera`` is the
``q`` camera dump (src/main.cpp:295), printed by the server and returned as
JSON. Frames render one at a time, under a lock.
"""
from __future__ import annotations

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from ..ops.camera import Camera
from ..utils import image_io

_PAGE = """<!DOCTYPE html>
<html><head><title>cudaneuralrender_torch viewer</title>
<style>
 body { margin:0; background:#111; color:#ddd; font-family:monospace; }
 #hud { position:fixed; top:8px; left:8px; background:#000a; padding:6px 10px; }
 canvas { display:block; margin:auto; image-rendering:pixelated; }
</style></head>
<body>
<div id="hud">drag=rotate wheel=zoom shift-drag=pan space=save f=frame p=play q=camera | <span id="stats"></span></div>
<canvas id="c"></canvas>
<script>
let rx=%RX%, ry=%RY%, zoom=%ZOOM%, tx=0, ty=0, frame=0, busy=false, dirty=true;
let playing=false, fpsTimes=[];
const c=document.getElementById('c'), ctx=c.getContext('2d');
const stats=document.getElementById('stats');
let drag=null;
c.width=%W%; c.height=%H%;
c.addEventListener('mousedown', e=>{drag=[e.clientX,e.clientY];});
window.addEventListener('mouseup', ()=>{drag=null;});
window.addEventListener('mousemove', e=>{
  if(!drag) return;
  const dx=e.clientX-drag[0], dy=e.clientY-drag[1];
  drag=[e.clientX,e.clientY];
  if(e.shiftKey){ tx+=dx*0.002*zoom; ty+=dy*0.002*zoom; } else { ry+=dx*0.25; rx+=dy*0.25; }
  dirty=true;
});
c.addEventListener('wheel', e=>{ zoom=Math.max(0.2, zoom+e.deltaY*0.002); dirty=true; e.preventDefault(); });
window.addEventListener('keydown', e=>{
  if(e.key===' '){ fetch(`/save?rx=${rx}&ry=${ry}&zoom=${zoom}&tx=${tx}&ty=${ty}&frame=${frame}`); }
  if(e.key==='f'){ frame=(frame+1)%360; dirty=true; }
  if(e.key==='p'){ playing=!playing; dirty=true; }
  if(e.key==='q'){
    fetch(`/camera?rx=${rx}&ry=${ry}&zoom=${zoom}&tx=${tx}&ty=${ty}&frame=${frame}`)
      .then(r=>r.json()).then(j=>console.log('camera', j));
  }
});
async function loop(){
  if((dirty || playing) && !busy){
    busy=true; dirty=false;
    if(playing){ frame=(frame+1)%360; }
    const t0=performance.now();
    const r=await fetch(`/frame?rx=${rx}&ry=${ry}&zoom=${zoom}&tx=${tx}&ty=${ty}&frame=${frame}`);
    const blob=await r.blob();
    const img=await createImageBitmap(blob);
    ctx.drawImageSmoothingEnabled=false;
    ctx.drawImage(img,0,0);
    const now=performance.now();
    fpsTimes.push(now);
    while(fpsTimes.length && fpsTimes[0] < now-3000) fpsTimes.shift();
    const fps=fpsTimes.length>1 ? (fpsTimes.length-1)/((now-fpsTimes[0])/1000) : 0;
    stats.textContent=`${(now-t0).toFixed(0)} ms  ${fps.toFixed(1)} fps`
      +`${playing?' [play]':''}  rx=${rx.toFixed(1)} ry=${ry.toFixed(1)} z=${zoom.toFixed(2)} f=${frame}`;
    busy=false;
  }
  requestAnimationFrame(loop);
}
loop();
</script></body></html>
"""


def make_server(renderer, camera: Camera = None, *, port: int = 8000,
                host: str = "127.0.0.1") -> ThreadingHTTPServer:
    """Build the viewer HTTP server (not started); ``renderer`` is a
    render.renderer.Renderer. Separate from ``serve`` so tests and embedders
    can run it on a thread and shut it down cleanly (``port=0`` takes a free
    port: ``server.server_address[1]``)."""
    camera = camera or Camera()
    init_rx = float(np.asarray(camera.rotation_x))
    init_ry = float(np.asarray(camera.rotation_y))
    init_zoom = -float(np.asarray(camera.translation)[2])
    cfg = renderer.config
    save_count = [0]
    lock = threading.Lock()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _render(self, q, interactive: bool = False):
            cam = Camera.from_cli(
                rx=float(q.get("rx", [init_rx])[0]),
                ry=float(q.get("ry", [init_ry])[0]),
                zoom=float(q.get("zoom", [init_zoom])[0]),
                tx=float(q.get("tx", [0.0])[0]),
                ty=float(q.get("ty", [0.0])[0]),
            )
            frame = float(q.get("frame", [0])[0])
            with lock:
                if interactive:
                    # live frames: the deferred check, one host sync a frame
                    return renderer.render_frame_interactive(cam, frame)
                return renderer.render_frame(cam, frame)

        def do_GET(self):
            url = urlparse(self.path)
            q = parse_qs(url.query)
            if url.path == "/":
                page = (
                    _PAGE.replace("%W%", str(cfg.width))
                    .replace("%H%", str(cfg.height))
                    .replace("%RX%", str(init_rx))
                    .replace("%RY%", str(init_ry))
                    .replace("%ZOOM%", str(init_zoom))
                )
                body = page.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif url.path == "/frame":
                img = self._render(q, interactive=True)
                buf = io.BytesIO()
                from PIL import Image

                Image.fromarray(np.ascontiguousarray(img)).save(buf, "PNG")
                body = buf.getvalue()
                self.send_response(200)
                self.send_header("Content-Type", "image/png")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif url.path == "/camera":
                # the reference's `q` camera dump (src/main.cpp:283-305):
                # printed by the server and returned as JSON.
                cam = {
                    "rotation_x": float(q.get("rx", [init_rx])[0]),
                    "rotation_y": float(q.get("ry", [init_ry])[0]),
                    "zoom": float(q.get("zoom", [init_zoom])[0]),
                    "translation_x": float(q.get("tx", [0.0])[0]),
                    "translation_y": float(q.get("ty", [0.0])[0]),
                    "frame": float(q.get("frame", [0])[0]),
                }
                print(
                    "camera: "
                    + " ".join(f"{k}={v:.4f}" for k, v in cam.items()),
                    flush=True,
                )
                body = json.dumps(cam).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif url.path == "/save":
                img = self._render(q)
                path = f"viewer_frame_{save_count[0]}.png"
                save_count[0] += 1
                image_io.save_png(path, img)
                body = json.dumps({"saved": path}).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self.send_response(404)
                self.end_headers()

    return ThreadingHTTPServer((host, port), Handler)


def serve(renderer, camera: Camera = None, *, port: int = 8000, host: str = "127.0.0.1"):
    """Run the viewer server until interrupted; ``renderer`` is a
    render.renderer.Renderer."""
    server = make_server(renderer, camera, port=port, host=host)
    print(f"viewer: http://{host}:{server.server_address[1]}/  (ctrl-c to stop)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
