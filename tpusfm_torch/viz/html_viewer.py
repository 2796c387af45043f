"""Standalone HTML point-cloud viewer.

The port's own copy of ``tpusfm/viz/html_viewer.py``: the replacement for the legacy interactive viewers (PCL
`RunVisualization` render loop, Visualization.cpp:197-297; Qt/QGLViewer
sfmviewer.cpp; FLTK DistanceUI.cpp): a single self-contained .html file
with the cloud + camera frusta embedded and vanilla-JS orbit/zoom/pan —
viewable from any browser, no installs, works from a headless pod via
file copy. Camera frusta rendering mirrors the PLY export's 4-corner
pyramid (SfM.cpp:668-710); points carry their per-point RGB.
"""
from __future__ import annotations

import json

import numpy as np

_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>tpusfm_torch viewer</title><style>
html,body{margin:0;height:100%;overflow:hidden;background:#111;color:#ccc;font:12px monospace}
#hud{position:fixed;top:8px;left:8px;z-index:2}
canvas{display:block}
</style></head><body>
<div id="hud">__NPTS__ points · __NCAMS__ cameras · drag=orbit wheel=zoom shift-drag=pan</div>
<canvas id="c"></canvas>
<script>
const PTS = __PTS__;   // [x,y,z,r,g,b]*N
const CAMS = __CAMS__; // per camera: 5 corner points [apex, c1..c4]
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
let W,H; function rs(){W=cv.width=innerWidth;H=cv.height=innerHeight;} rs(); onresize=rs;
// center + scale
let cx=0,cy=0,cz=0; const n=PTS.length/6;
for(let i=0;i<n;i++){cx+=PTS[6*i];cy+=PTS[6*i+1];cz+=PTS[6*i+2];} cx/=n;cy/=n;cz/=n;
let sc=0; for(let i=0;i<n;i++){sc+=Math.hypot(PTS[6*i]-cx,PTS[6*i+1]-cy,PTS[6*i+2]-cz);} sc/=n;
let yaw=0.5, pitch=-0.4, dist=4*sc, panx=0, pany=0;
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
  for(let i=0;i<n;i++){
    const p=project(PTS[6*i],PTS[6*i+1],PTS[6*i+2]); if(!p) continue;
    ctx.fillStyle=`rgb(${PTS[6*i+3]},${PTS[6*i+4]},${PTS[6*i+5]})`;
    const r=Math.max(1, 2.2*sc/p[2]);
    ctx.fillRect(p[0],p[1],r,r);
  }
  ctx.strokeStyle='#e33'; ctx.lineWidth=1;
  for(const cam of CAMS){
    const q=cam.map(v=>project(v[0],v[1],v[2]));
    if(q.some(v=>!v)) continue;
    ctx.beginPath();
    for(let k=1;k<=4;k++){ctx.moveTo(q[0][0],q[0][1]);ctx.lineTo(q[k][0],q[k][1]);}
    ctx.moveTo(q[1][0],q[1][1]);ctx.lineTo(q[2][0],q[2][1]);ctx.lineTo(q[3][0],q[3][1]);
    ctx.lineTo(q[4][0],q[4][1]);ctx.lineTo(q[1][0],q[1][1]);
    ctx.stroke();
  }
}
let drag=null;
cv.onmousedown=e=>drag=[e.clientX,e.clientY,e.shiftKey];
onmouseup=()=>drag=null;
onmousemove=e=>{ if(!drag) return;
  const dx=e.clientX-drag[0], dy=e.clientY-drag[1];
  if(drag[2]){panx+=dx;pany+=dy;} else {yaw+=dx*0.008;pitch+=dy*0.008;}
  drag=[e.clientX,e.clientY,drag[2]]; requestAnimationFrame(draw); };
cv.onwheel=e=>{dist*=Math.exp(e.deltaY*0.001); requestAnimationFrame(draw); e.preventDefault();};
draw();
</script></body></html>
"""


def export_html_viewer(path: str, xyz: np.ndarray, rgb: np.ndarray | None,
                       poses: np.ndarray, pose_valid: np.ndarray,
                       max_points: int = 100000):
    """Write a self-contained interactive viewer for a reconstruction."""
    xyz = np.asarray(xyz, np.float32)
    if rgb is None:
        rgb = np.full((len(xyz), 3), 220, np.uint8)
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8:
        rgb = np.clip(rgb * 255.0 if rgb.max() <= 1.0 + 1e-6 else rgb, 0, 255).astype(np.uint8)
    if len(xyz) > max_points:
        sel = np.random.default_rng(0).choice(len(xyz), max_points, replace=False)
        xyz, rgb = xyz[sel], rgb[sel]
    pts = np.concatenate([xyz, rgb.astype(np.float32)], axis=1).round(4)

    scale = float(np.median(np.linalg.norm(xyz - np.median(xyz, 0), axis=1))) if len(xyz) else 1.0
    s = max(0.08 * (scale or 1.0), 1e-3)
    local = np.array([[0, 0, 0], [-s, -s, 2 * s], [s, -s, 2 * s],
                      [s, s, 2 * s], [-s, s, 2 * s]], np.float32)
    cams = []
    for Rt in np.asarray(poses)[np.asarray(pose_valid, bool)]:
        R, t = Rt[:, :3], Rt[:, 3]
        c = -R.T @ t
        cams.append(((local @ R) + c).round(4).tolist())

    html = (_TEMPLATE
            .replace("__PTS__", json.dumps(pts.ravel().tolist()))
            .replace("__CAMS__", json.dumps(cams))
            .replace("__NPTS__", str(len(xyz)))
            .replace("__NCAMS__", str(len(cams))))
    with open(path, "w") as f:
        f.write(html)
