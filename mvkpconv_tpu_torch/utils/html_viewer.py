"""Standalone interactive point-cloud viewer: one self-contained HTML file,
a copy of ``mvkpconv_tpu/utils/html_viewer.py`` (the same bytes for the same
arrays: ``tests/test_torch_tools_io.py``).

Replaces the interactive half of the reference's visualization layer
(KPConv-PyTorch/utils/visualizer.py:1-531 ``ModelVisualizer`` — a mayavi
window with keyboard stepping through deformed kernels / features, and the
mayavi prediction viewers in mvpnet/utils/visualize.py) in a form that
works from a headless host: the artifact is a single HTML file with the
cloud data embedded (base64 float32/uint8) and a zero-dependency canvas
renderer — orbit (drag), zoom (wheel), pan (shift-drag), per-cloud toggles,
point-size control, and a class legend. Open it in any browser; nothing to
install, no network access needed.

Rendering is a z-buffered splat pass into an ``ImageData`` buffer (painter
sorting would be O(N log N) per frame; the z-buffer keeps a 400k-point
cloud interactive), which also gives correct occlusion between overlaid
clouds (e.g. deformed kernel points in front of / behind the scene).
"""

from __future__ import annotations

import base64
import json
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from mvkpconv_tpu_torch.data.meta import SCANNET_COLOR_PALETTE

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>__TITLE__</title><style>
 body{margin:0;background:#111;color:#ddd;font:13px system-ui,sans-serif;overflow:hidden}
 #hud{position:fixed;top:8px;left:8px;background:rgba(20,20,20,.85);padding:8px 10px;
      border-radius:6px;max-height:92vh;overflow:auto}
 #hud label{display:block;margin:2px 0;cursor:pointer}
 .sw{display:inline-block;width:10px;height:10px;margin-right:6px;border-radius:2px}
 #help{position:fixed;bottom:8px;left:8px;color:#888}
 input[type=range]{vertical-align:middle}
</style></head><body>
<canvas id="c"></canvas>
<div id="hud"><b>__TITLE__</b><div id="clouds"></div>
 <label>point size <input id="psz" type="range" min="1" max="5" value="__PSIZE__"></label>
 <div id="legend"></div></div>
<div id="help">drag: orbit &nbsp; wheel: zoom &nbsp; shift-drag: pan</div>
<script>
"use strict";
const META = __META__;
function decode(b64, T){const s=atob(b64),n=s.length,u=new Uint8Array(n);
  for(let i=0;i<n;i++)u[i]=s.charCodeAt(i);return new T(u.buffer);}
const clouds = META.clouds.map(c=>({name:c.name,on:c.on,
  xyz:decode(c.xyz,Float32Array),rgb:decode(c.rgb,Uint8Array),size:c.size}));
const cv=document.getElementById('c'),ctx=cv.getContext('2d');
let W,H,img,zbuf;
function resize(){W=cv.width=innerWidth;H=cv.height=innerHeight;
  img=ctx.createImageData(W,H);zbuf=new Float32Array(W*H);}
addEventListener('resize',()=>{resize();draw();});resize();
let yaw=0.6,pitch=0.5,dist=2.4*META.scale,panX=0,panY=0;
function draw(){
  img.data.fill(0);for(let i=3;i<img.data.length;i+=4)img.data[i]=255;
  zbuf.fill(Infinity);
  const cy=Math.cos(yaw),sy=Math.sin(yaw),cp=Math.cos(pitch),sp=Math.sin(pitch);
  const f=0.9*Math.min(W,H),psz=+document.getElementById('psz').value;
  for(const c of clouds){ if(!c.on) continue;
    const xyz=c.xyz,rgb=c.rgb,n=xyz.length/3,r=Math.max(0,(psz*c.size|0)-1);
    for(let i=0;i<n;i++){
      const x0=xyz[3*i],y0=xyz[3*i+1],z0=xyz[3*i+2];
      const x1=cy*x0+sy*y0, y1=-sy*x0+cy*y0;          // yaw about z
      const y2=cp*y1-sp*z0, z2=sp*y1+cp*z0;           // pitch
      const zc=y2+dist; if(zc<1e-3*META.scale) continue;
      const px=(W>>1)+panX+f*x1/zc, py=(H>>1)+panY-f*z2/zc;
      const xi=px|0, yi=py|0;
      if(xi<r||yi<r||xi>=W-r||yi>=H-r) continue;
      for(let dy=-r;dy<=r;dy++)for(let dx=-r;dx<=r;dx++){
        const o=(yi+dy)*W+xi+dx;
        if(zc<zbuf[o]){zbuf[o]=zc;const o4=4*o;
          img.data[o4]=rgb[3*i];img.data[o4+1]=rgb[3*i+1];img.data[o4+2]=rgb[3*i+2];}
      }
    }
  }
  ctx.putImageData(img,0,0);
}
let drag=null;
cv.onmousedown=e=>drag={x:e.clientX,y:e.clientY,pan:e.shiftKey};
addEventListener('mouseup',()=>drag=null);
addEventListener('mousemove',e=>{if(!drag)return;
  const dx=e.clientX-drag.x,dy=e.clientY-drag.y;drag.x=e.clientX;drag.y=e.clientY;
  if(drag.pan){panX+=dx;panY+=dy;}else{yaw+=dx*0.008;
    pitch=Math.max(-1.55,Math.min(1.55,pitch+dy*0.008));}
  requestAnimationFrame(draw);});
cv.onwheel=e=>{e.preventDefault();dist*=Math.exp(e.deltaY*0.001);
  requestAnimationFrame(draw);};
document.getElementById('psz').oninput=()=>requestAnimationFrame(draw);
const cl=document.getElementById('clouds');
clouds.forEach((c,i)=>{const l=document.createElement('label');
  const b=document.createElement('input');b.type='checkbox';b.checked=c.on;
  b.onchange=()=>{c.on=b.checked;requestAnimationFrame(draw);};
  l.appendChild(b);l.appendChild(document.createTextNode(' '+c.name+
    ' ('+(c.xyz.length/3)+' pts)'));cl.appendChild(l);});
const lg=document.getElementById('legend');
for(const e of META.legend){const l=document.createElement('label');
  l.innerHTML='<span class="sw" style="background:rgb('+e[1]+')"></span>'+e[0];
  lg.appendChild(l);}
draw();
</script></body></html>
"""


def _b64(arr: np.ndarray) -> str:
    return base64.b64encode(np.ascontiguousarray(arr).tobytes()).decode("ascii")


def save_html_viewer(
    path,
    clouds: Sequence[dict],
    class_names: Optional[Sequence[str]] = None,
    title: str = "mvkpconv_tpu viewer",
    point_size: int = 2,
    max_points: int = 400_000,
) -> Path:
    """Write a standalone interactive viewer HTML.

    Args:
      clouds: list of dicts, each with ``name``, ``points`` (N, 3) float,
        and ONE of ``colors`` (N, 3) uint8 or ``labels`` (N,) int (mapped
        through the ScanNet palette; <0 renders black). Optional per-cloud
        keys: ``on`` (initially visible, default True) and ``size``
        (splat-radius multiplier, e.g. 3 for kernel-point overlays).
      class_names: when given, a palette legend is rendered for the label
        ids actually present across all labeled clouds.
      max_points: per-cloud uniform subsample bound (keeps the artifact
        size and the JS frame time sane for whole-scene clouds).
    """
    from mvkpconv_tpu_torch.utils.visualize import labels_to_colors

    out_clouds, legend_ids = [], set()
    all_pts = []
    for c in clouds:
        pts = np.asarray(c["points"], np.float32).reshape(-1, 3)
        if "colors" in c and c["colors"] is not None:
            rgb = np.asarray(c["colors"]).astype(np.uint8).reshape(-1, 3)
        else:
            lab = np.asarray(c["labels"]).reshape(-1)
            rgb = labels_to_colors(lab)
            legend_ids.update(int(v) for v in np.unique(lab) if v >= 0)
        if len(pts) > max_points:
            keep = np.random.default_rng(0).choice(
                len(pts), max_points, replace=False
            )
            pts, rgb = pts[keep], rgb[keep]
        all_pts.append(pts)
        out_clouds.append((c["name"], pts, rgb,
                           bool(c.get("on", True)), float(c.get("size", 1.0))))

    cat = np.concatenate(all_pts, 0) if all_pts else np.zeros((1, 3), np.float32)
    center = cat.mean(0)
    scale = float(max(np.abs(cat - center).max(), 1e-6))

    meta = {
        "scale": 1.0,
        "clouds": [
            {
                "name": name,
                "xyz": _b64((pts - center) / scale),
                "rgb": _b64(rgb),
                "on": on,
                "size": size,
            }
            for name, pts, rgb, on, size in out_clouds
        ],
        "legend": [
            [class_names[i], ",".join(map(str, SCANNET_COLOR_PALETTE[i % len(SCANNET_COLOR_PALETTE)]))]
            for i in sorted(legend_ids)
            if class_names is not None and i < len(class_names)
        ],
    }
    html = (
        _PAGE.replace("__TITLE__", title)
        .replace("__PSIZE__", str(int(point_size)))
        .replace("__META__", json.dumps(meta))
    )
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(html)
    return path


def prediction_viewer_html(
    path,
    points: np.ndarray,
    pred: np.ndarray,
    labels: Optional[np.ndarray] = None,
    class_names: Optional[Sequence[str]] = None,
    title: str = "prediction",
) -> Path:
    """Prediction / ground-truth / error-mask viewer for one scene (the
    interactive twin of ``visualize.save_prediction_ply``)."""
    clouds = [{"name": "prediction", "points": points, "labels": pred}]
    if labels is not None:
        labels = np.asarray(labels)
        err = (np.asarray(pred) != labels) & (labels >= 0)
        clouds.append({"name": "ground truth", "points": points,
                       "labels": labels, "on": False})
        red = np.zeros((int(err.sum()), 3), np.uint8)
        red[:, 0] = 255
        clouds.append({"name": "errors", "points": np.asarray(points)[err],
                       "colors": red, "on": False, "size": 1.5})
    return save_html_viewer(path, clouds, class_names=class_names, title=title)
