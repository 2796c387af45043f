"""Live listener-fed reconstruction viewer.

The port's own copy of ``tpusfm/viz/live_viewer.py``.

Completes the legacy interactive-UI capability (L14): the Qt/QGLViewer
`SFMViewer` runs the pipeline on a worker thread and redraws the growing
cloud on every `update()` callback (legacy/sfmviewer.cpp:32-115, observer
registered via SfMUpdateListener.h:33-41). This equivalent is
headless-friendly:

  viewer = LiveViewer("/tmp/rec_live.html")   # optional: .serve(port)
  pipe.add_listener(viewer.update)
  pipe.run()

Every listener notification appends a frame (cloud snapshot + cameras).
Two consumption modes:
  * file mode — the HTML is atomically rewritten per frame with ALL
    frames embedded and a timeline slider (+live autoplay), so opening
    the file at any moment shows the reconstruction's history;
  * serve mode — `viewer.serve(port)` starts a daemon HTTP server; the
    page then polls /frames.json once a second and follows the newest
    frame as it lands, a real streaming view of a running reconstruction.

Note the classic host-driven pipeline feeds listeners per registered
view; the fused device engine intentionally skips observers (it exists
to avoid per-view host synchronization), so SfMPipeline routes runs with
listeners through the classic path.
"""
from __future__ import annotations

import json
import os
import threading

import numpy as np

_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>tpusfm_torch live</title><style>
html,body{margin:0;height:100%;overflow:hidden;background:#111;color:#ccc;font:12px monospace}
#hud{position:fixed;top:8px;left:8px;z-index:2}
#bar{position:fixed;bottom:8px;left:8px;right:8px;z-index:2;display:flex;gap:8px;align-items:center}
#seek{flex:1}
canvas{display:block}
</style></head><body>
<div id="hud"></div>
<div id="bar"><span id="lbl"></span><input id="seek" type="range" min="0" value="0"></div>
<canvas id="c"></canvas>
<script>
let FRAMES = __FRAMES__;
const LIVE = __LIVE__;
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
const seek = document.getElementById('seek'), lbl = document.getElementById('lbl');
let W,H; function rs(){W=cv.width=innerWidth;H=cv.height=innerHeight;draw();} onresize=rs;
let cur = FRAMES.length-1, follow = true;
let yaw=0.5, pitch=-0.4, dist=0, panx=0, pany=0, sc=1, cx=0, cy=0, cz=0;
function fit(fr){
  const P=fr.pts, n=P.length/6; if(!n) return;
  cx=0;cy=0;cz=0;
  for(let i=0;i<n;i++){cx+=P[6*i];cy+=P[6*i+1];cz+=P[6*i+2];} cx/=n;cy/=n;cz/=n;
  sc=0; for(let i=0;i<n;i++){sc+=Math.hypot(P[6*i]-cx,P[6*i+1]-cy,P[6*i+2]-cz);} sc/=n;
  if(dist===0) dist=4*sc;
}
function project(x,y,z){
  x-=cx;y-=cy;z-=cz;
  let c=Math.cos(yaw),s=Math.sin(yaw);
  let x1=c*x+s*z, z1=-s*x+c*z;
  c=Math.cos(pitch); s=Math.sin(pitch);
  let y2=c*y-s*z1, z2=s*y+c*z1;
  z2+=dist;
  if(z2<=0.01*sc) return null;
  const f=0.9*Math.min(W,H);
  return [W/2+f*x1/z2+panx, H/2+f*y2/z2+pany, z2];
}
function draw(){
  ctx.fillStyle='#111'; ctx.fillRect(0,0,W,H);
  if(!FRAMES.length) return;
  const fr=FRAMES[cur]; fit(fr);
  const P=fr.pts, n=P.length/6;
  for(let i=0;i<n;i++){
    const p=project(P[6*i],P[6*i+1],P[6*i+2]); if(!p) continue;
    ctx.fillStyle=`rgb(${P[6*i+3]},${P[6*i+4]},${P[6*i+5]})`;
    ctx.fillRect(p[0],p[1],Math.max(1,2.2*sc/p[2]),Math.max(1,2.2*sc/p[2]));
  }
  ctx.strokeStyle='#e33'; ctx.lineWidth=1;
  for(const cam of fr.cams){
    const q=cam.map(v=>project(v[0],v[1],v[2]));
    if(q.some(v=>!v)) continue;
    ctx.beginPath();
    for(let k=1;k<=4;k++){ctx.moveTo(q[0][0],q[0][1]);ctx.lineTo(q[k][0],q[k][1]);}
    ctx.moveTo(q[1][0],q[1][1]);ctx.lineTo(q[2][0],q[2][1]);ctx.lineTo(q[3][0],q[3][1]);
    ctx.lineTo(q[4][0],q[4][1]);ctx.lineTo(q[1][0],q[1][1]);
    ctx.stroke();
  }
  lbl.textContent = `frame ${cur+1}/${FRAMES.length}`;
  document.getElementById('hud').textContent =
    `${n} points - ${fr.cams.length} cameras` + (LIVE ? ' - LIVE' : '');
  seek.max = FRAMES.length-1; seek.value = cur;
}
seek.oninput = e => {cur = +e.target.value; follow = (cur === FRAMES.length-1); draw();};
let drag=null;
cv.onmousedown=e=>drag=[e.clientX,e.clientY,e.shiftKey];
onmouseup=()=>drag=null;
onmousemove=e=>{ if(!drag) return;
  const dx=e.clientX-drag[0], dy=e.clientY-drag[1];
  if(drag[2]){panx+=dx;pany+=dy;} else {yaw+=dx*0.008;pitch+=dy*0.008;}
  drag=[e.clientX,e.clientY,drag[2]]; requestAnimationFrame(draw); };
cv.onwheel=e=>{dist*=Math.exp(e.deltaY*0.001); requestAnimationFrame(draw); e.preventDefault();};
if(LIVE){
  setInterval(async()=>{
    try{
      const r=await fetch('frames.json',{cache:'no-store'});
      const f=await r.json();
      if(f.length!==FRAMES.length){FRAMES=f; if(follow) cur=FRAMES.length-1; draw();}
    }catch(err){}
  },1000);
}
rs();
</script></body></html>
"""


class LiveViewer:
    """Observer that streams reconstruction snapshots into a browser view.

    Register with ``pipe.add_listener(viewer.update)``; each callback
    (after the baseline and after every registered view,
    MultiCameraPnP.cpp:502,575 semantics) appends a frame.
    """

    def __init__(self, html_path: str, max_points: int = 60000):
        self.html_path = html_path
        self.max_points = max_points
        self.frames = []
        self._lock = threading.Lock()
        self._server = None
        self._write_html(live=False)

    # -- observer callback (SfMUpdateListener::update equivalent) -------- #
    def update(self, xyz: np.ndarray, rgb: np.ndarray, poses: np.ndarray,
               pose_valid: np.ndarray):
        xyz = np.asarray(xyz, np.float32)
        rgb = np.asarray(rgb)
        if rgb.dtype != np.uint8:
            rgb = np.clip(rgb * 255.0 if rgb.size and rgb.max() <= 1.0 + 1e-6
                          else rgb, 0, 255).astype(np.uint8)
        if len(xyz) > self.max_points:
            sel = np.random.default_rng(0).choice(len(xyz), self.max_points,
                                                  replace=False)
            xyz, rgb = xyz[sel], rgb[sel]
        pts = np.concatenate([xyz, rgb.astype(np.float32)], axis=1)
        scale = float(np.median(np.linalg.norm(
            xyz - np.median(xyz, 0), axis=1))) if len(xyz) else 1.0
        s = max(0.08 * (scale or 1.0), 1e-3)
        local = np.array([[0, 0, 0], [-s, -s, 2 * s], [s, -s, 2 * s],
                          [s, s, 2 * s], [-s, s, 2 * s]], np.float32)
        cams = []
        for Rt in np.asarray(poses)[np.asarray(pose_valid, bool)]:
            R, t = Rt[:, :3], Rt[:, 3]
            c = -R.T @ t
            cams.append(((local @ R) + c).round(4).tolist())
        frame = {"pts": np.round(pts, 4).ravel().tolist(), "cams": cams}
        with self._lock:
            self.frames.append(frame)
            self._write_frames_json()
            self._write_html(live=self._server is not None)

    # -- outputs ---------------------------------------------------------- #
    def _write_frames_json(self):
        path = os.path.join(os.path.dirname(self.html_path) or ".", "frames.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.frames, f)
        os.replace(tmp, path)

    def _write_html(self, live: bool):
        html = (_TEMPLATE
                .replace("__FRAMES__", json.dumps(self.frames))
                .replace("__LIVE__", "true" if live else "false"))
        tmp = self.html_path + ".tmp"
        with open(tmp, "w") as f:
            f.write(html)
        os.replace(tmp, self.html_path)

    # -- optional true-streaming mode -------------------------------------- #
    def serve(self, port: int = 8008):
        """Serve the viewer directory over HTTP in a daemon thread; the
        page then live-polls frames.json (the SFMViewer render-thread
        role, sfmviewer.cpp:73-75). Returns the URL."""
        import functools
        import http.server

        directory = os.path.dirname(os.path.abspath(self.html_path)) or "."
        handler = functools.partial(http.server.SimpleHTTPRequestHandler,
                                    directory=directory)
        self._server = http.server.ThreadingHTTPServer(("0.0.0.0", port), handler)
        threading.Thread(target=self._server.serve_forever, daemon=True).start()
        self._write_html(live=True)
        return f"http://localhost:{port}/{os.path.basename(self.html_path)}"

    def close(self):
        if self._server is not None:
            self._server.shutdown()
            self._server = None
