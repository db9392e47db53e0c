"""replay_viewer: a saved run directory as one interactive HTML page.

PyTorch port of the JAX package's ``tools/replay_viewer.py`` (the replay
equivalent of the reference's GUI, sources/gui/visualizer.h:81-177 and its
surfel shader shaders/drawkf.geom:1-186): it loads a run directory written
by ``DeepFactors.save_results`` (trajectory.txt, keyframes.txt,
kf_<id>_img.png / kf_<id>_dpt.png, intrinsics.txt) and writes ONE
self-contained HTML file (no external assets, vanilla JS) with an
orbitable 3D view of every keyframe back-projected to a point-splat surfel
cloud, the trajectory, a replay timeline and intensity / depth / keyframe
colour modes. The page template is the JAX tool's, verbatim, so that the
same run directory gives the same page.

Host numpy only: the PNGs go through ``io/image_io`` (depth uint16 / 5000,
as ``save_results`` writes it), the quaternions become rotations in numpy,
and no tensor reaches a device. ``--device`` (default cuda) is checked like
every entry's.

Usage: python -m deepfactors_tpu_torch.tools.replay_viewer <run_dir>
       [--out viewer.html] [--stride 2] [--max-depth 8.0] [--device cpu]
"""
from __future__ import annotations

import argparse
import base64
import glob
import json
import os
import re
import sys

import numpy as np

from ..io import image_io
from ..utils import tum_io
from .common import device_from_flag


def load_run(run_dir):
    """Load trajectory, keyframe poses, per-kf image/depth, intrinsics."""
    out = {}
    tf = os.path.join(run_dir, "trajectory.txt")
    out["trajectory"] = tum_io.load_trajectory(tf) if os.path.exists(tf) \
        else []
    kf = os.path.join(run_dir, "keyframes.txt")
    out["kf_poses"] = tum_io.load_trajectory(kf) if os.path.exists(kf) \
        else []
    fx = fy = u0 = v0 = None
    intr = os.path.join(run_dir, "intrinsics.txt")
    if os.path.exists(intr):
        with open(intr) as f:
            fx, fy, u0, v0 = map(float, f.read().split()[:4])
    out["intrinsics"] = (fx, fy, u0, v0)
    kfs = {}
    for p in glob.glob(os.path.join(run_dir, "kf_*_img.png")):
        m = re.match(r"kf_(\d+)_img\.png", os.path.basename(p))
        if not m:
            continue
        kid = int(m.group(1))
        dp = os.path.join(run_dir, f"kf_{kid}_dpt.png")
        if os.path.exists(dp):
            kfs[kid] = (p, dp)
    out["kf_files"] = kfs
    return out


def backproject(img_path, dpt_path, pose_q, pose_t, intr, stride=2,
                max_depth=8.0):
    """Depth map -> world-frame surfel points (pos[N,3], intensity[N],
    depth[N]). Pose is camera-to-world (q wxyz, t), codebase convention."""
    img = image_io.imread(img_path, "gray").astype(np.float32) / 255.0
    dpt = image_io.imread(dpt_path, "any_depth").astype(np.float32) / 5000.0
    h, w = img.shape
    fx, fy, u0, v0 = intr
    if fx is None:
        fx = fy = 0.5 * (w + h)
        u0, v0 = w / 2.0, h / 2.0
    ys, xs = np.mgrid[0:h:stride, 0:w:stride]
    z = dpt[ys, xs]
    ok = (z > 1e-3) & (z < max_depth) & np.isfinite(z)
    xs, ys, z = xs[ok], ys[ok], z[ok]
    pc = np.stack([(xs - u0) / fx * z, (ys - v0) / fy * z, z], axis=-1)
    # quat (wxyz) -> rotation matrix in numpy: the viewer touches no device
    qw, qx, qy, qz = (float(v) for v in np.asarray(pose_q, np.float64))
    R = np.array([
        [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz),
         2 * (qx * qz + qw * qy)],
        [2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz),
         2 * (qy * qz - qw * qx)],
        [2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx),
         1 - 2 * (qx * qx + qy * qy)],
    ], np.float32)
    pw = pc @ R.T + np.asarray(pose_t, np.float32)[None, :]
    return pw.astype(np.float32), img[ys, xs].astype(np.float32), \
        z.astype(np.float32)


def pack_f32(a):
    a = np.ascontiguousarray(a, np.float32)
    return base64.b64encode(a.tobytes()).decode("ascii")


HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>deepfactors_tpu replay</title>
<style>
 body{margin:0;background:#10131a;color:#cfd6e4;font:13px/1.4 system-ui,sans-serif;overflow:hidden}
 #hud{position:fixed;left:12px;top:10px;z-index:3;user-select:none}
 #bar{position:fixed;left:12px;right:12px;bottom:12px;z-index:3;display:flex;gap:10px;align-items:center}
 #seek{flex:1}
 button,select{background:#222838;color:#cfd6e4;border:1px solid #39415a;border-radius:4px;padding:3px 10px;cursor:pointer}
 canvas{display:block}
 .dim{color:#7c879e}
</style></head><body>
<div id="hud"><b>deepfactors_tpu</b> replay — <span id="stat" class="dim"></span><br>
<span class="dim">drag orbit · wheel zoom · shift-drag pan</span></div>
<div id="bar">
 <button id="play">&#9654;</button>
 <input type="range" id="seek" min="0" max="1000" value="1000">
 <select id="cmode"><option value="0">intensity</option>
  <option value="1">depth</option><option value="2">keyframe</option></select>
 <span id="tlabel" class="dim"></span>
</div>
<canvas id="cv"></canvas>
<script>
const DATA = __DATA__;
function unb64(s){const b=atob(s);const a=new Uint8Array(b.length);
 for(let i=0;i<b.length;i++)a[i]=b.charCodeAt(i);return new Float32Array(a.buffer);}
const kfs = DATA.keyframes.map(k=>({id:k.id,ts:k.ts,pose:k.pose,
 pos:unb64(k.pos),inten:unb64(k.inten),dep:unb64(k.dep)}));
const traj = unb64(DATA.traj);           // [M*4]: ts,x,y,z
const M = traj.length/4;
const tmin = DATA.tmin, tmax = DATA.tmax;
const cv=document.getElementById('cv'),ctx=cv.getContext('2d');
let Wv,Hv,imgData,zbuf;
function resize(){Wv=innerWidth;Hv=innerHeight;cv.width=Wv;cv.height=Hv;
 imgData=ctx.createImageData(Wv,Hv);zbuf=new Float32Array(Wv*Hv);draw();}
addEventListener('resize',resize);
// orbit camera around the scene centroid
let ctr=[0,0,0],rad=1;
{let n=0,s=[0,0,0];for(const k of kfs){for(let i=0;i<k.pos.length;i+=30){
  s[0]+=k.pos[i];s[1]+=k.pos[i+1];s[2]+=k.pos[i+2];n++;}}
 if(n){ctr=s.map(v=>v/n);let r=0;for(const k of kfs){
  for(let i=0;i<k.pos.length;i+=30){const dx=k.pos[i]-ctr[0],dy=k.pos[i+1]-ctr[1],dz=k.pos[i+2]-ctr[2];
   r=Math.max(r,dx*dx+dy*dy+dz*dz);}}rad=Math.sqrt(r)||1;}}
let yaw=-0.6,pitch=0.45,dist=rad*2.2,pan=[0,0,0];
let drag=null;
cv.addEventListener('mousedown',e=>{drag={x:e.clientX,y:e.clientY,shift:e.shiftKey};});
addEventListener('mouseup',()=>drag=null);
addEventListener('mousemove',e=>{if(!drag)return;
 const dx=e.clientX-drag.x,dy=e.clientY-drag.y;drag.x=e.clientX;drag.y=e.clientY;
 if(drag.shift){const s=dist/600;
  pan[0]-=(dx*Math.cos(yaw)) *s; pan[2]-=(dx*Math.sin(yaw))*s; pan[1]+=dy*s;}
 else{yaw+=dx*0.008;pitch=Math.min(1.5,Math.max(-1.5,pitch+dy*0.008));}
 draw();});
cv.addEventListener('wheel',e=>{dist*=Math.exp(e.deltaY*0.0012);draw();e.preventDefault();},{passive:false});
const turbo=t=>{t=Math.min(1,Math.max(0,t));  // compact depth colormap
 return [Math.floor(255*Math.min(1,Math.max(0,1.6-Math.abs(4*t-3.2)))),
         Math.floor(255*Math.min(1,Math.max(0,1.6-Math.abs(4*t-1.8)))),
         Math.floor(255*Math.min(1,Math.max(0,1.6-Math.abs(4*t-0.6))))];};
const kfcol=i=>{const h=(i*0.618034)%1;const f=(n)=>{
  const k=(n+h*6)%6;return Math.floor(255*(1-Math.max(0,Math.min(k,4-k,1))*0.8));};
 return [f(5),f(3),f(1)];};
let tcur=1.0;  // replay fraction
function draw(){
 const cm=+document.getElementById('cmode').value;
 imgData.data.fill(0);zbuf.fill(1e30);
 for(let i=3;i<imgData.data.length;i+=4)imgData.data[i]=255;
 const cy=Math.cos(yaw),sy=Math.sin(yaw),cp=Math.cos(pitch),sp=Math.sin(pitch);
 const eye=[ctr[0]+pan[0]+dist*cy*cp,ctr[1]+pan[1]+dist*sp,ctr[2]+pan[2]+dist*sy*cp];
 const la=[ctr[0]+pan[0],ctr[1]+pan[1],ctr[2]+pan[2]];
 let fz=[la[0]-eye[0],la[1]-eye[1],la[2]-eye[2]];
 const fn=Math.hypot(...fz);fz=fz.map(v=>v/fn);
 let rx=[fz[2],0,-fz[0]];const rn=Math.hypot(...rx)||1;rx=rx.map(v=>v/rn);
 const up=[rx[1]*fz[2]-rx[2]*fz[1],rx[2]*fz[0]-rx[0]*fz[2],rx[0]*fz[1]-rx[1]*fz[0]];
 const fl=0.9*Math.min(Wv,Hv);
 const tlim=tmin+(tmax-tmin)*tcur;
 const D=imgData.data;
 const sz=dist<rad?2:1;   // bigger splats when close
 for(let ki=0;ki<kfs.length;ki++){const k=kfs[ki];
  if(k.ts>tlim)continue;
  const P=k.pos,I=k.inten,Z=k.dep,n=I.length;
  for(let i=0;i<n;i++){
   const px=P[3*i]-eye[0],py=P[3*i+1]-eye[1],pz=P[3*i+2]-eye[2];
   const z=px*fz[0]+py*fz[1]+pz*fz[2];if(z<0.05)continue;
   const x=(px*rx[0]+py*rx[1]+pz*rx[2])/z*fl+Wv/2;
   const y=-(px*up[0]+py*up[1]+pz*up[2])/z*fl+Hv/2;
   if(x<0||y<0||x>=Wv-sz||y>=Hv-sz)continue;
   let r,g,b;
   if(cm===0){const v=Math.floor(I[i]*255);r=g=b=v;}
   else if(cm===1){[r,g,b]=turbo(Z[i]/6.0);}
   else {[r,g,b]=kfcol(k.id);const v=0.35+0.65*I[i];r*=v;g*=v;b*=v;}
   for(let oy=0;oy<sz;oy++)for(let ox=0;ox<sz;ox++){
    const o=((y|0)+oy)*Wv+((x|0)+ox);
    if(z<zbuf[o]){zbuf[o]=z;const j=4*o;D[j]=r;D[j+1]=g;D[j+2]=b;}}
  }}
 ctx.putImageData(imgData,0,0);
 // trajectory polyline + camera frusta markers
 ctx.lineWidth=1.6;ctx.strokeStyle='#4da3ff';ctx.beginPath();let started=false;
 const proj=(wx,wy,wz)=>{const px=wx-eye[0],py=wy-eye[1],pz=wz-eye[2];
  const z=px*fz[0]+py*fz[1]+pz*fz[2];if(z<0.05)return null;
  return [(px*rx[0]+py*rx[1]+pz*rx[2])/z*fl+Wv/2,
          -(px*up[0]+py*up[1]+pz*up[2])/z*fl+Hv/2];};
 let nshown=0;
 for(let i=0;i<M;i++){if(traj[4*i]>tlim)break;nshown++;
  const s=proj(traj[4*i+1],traj[4*i+2],traj[4*i+3]);
  if(!s){started=false;continue;}
  if(started)ctx.lineTo(s[0],s[1]);else{ctx.moveTo(s[0],s[1]);started=true;}}
 ctx.stroke();
 let nk=0;for(const k of kfs)if(k.ts<=tlim)nk++;
 document.getElementById('stat').textContent=
  `${nk}/${kfs.length} keyframes · ${nshown}/${M} poses · t=${tlim.toFixed(1)}`;
 document.getElementById('tlabel').textContent=tlim.toFixed(1);
}
const seek=document.getElementById('seek');
seek.addEventListener('input',()=>{tcur=seek.value/1000;playing=false;
 document.getElementById('play').innerHTML='&#9654;';draw();});
let playing=false,lastT=0;
document.getElementById('play').addEventListener('click',function(){
 playing=!playing;this.innerHTML=playing?'&#10074;&#10074;':'&#9654;';
 if(playing){if(tcur>=1)tcur=0;lastT=performance.now();requestAnimationFrame(tick);}});
function tick(now){if(!playing)return;
 tcur+=(now-lastT)/12000;lastT=now;
 if(tcur>=1){tcur=1;playing=false;document.getElementById('play').innerHTML='&#9654;';}
 seek.value=Math.floor(tcur*1000);draw();
 if(playing)requestAnimationFrame(tick);}
document.getElementById('cmode').addEventListener('change',draw);
resize();
</script></body></html>
"""


def build_html(run, stride=2, max_depth=8.0):
    intr = run["intrinsics"]
    kf_ts = {}
    for ts, pose in run["kf_poses"]:
        kf_ts[int(round(ts))] = (ts, pose)
    keyframes = []
    for kid, (ip_, dp_) in sorted(run["kf_files"].items()):
        if kid in kf_ts:
            ts, pose = kf_ts[kid]
            q = np.asarray(pose.q, np.float32)
            t = np.asarray(pose.t, np.float32)
        else:
            ts, q, t = float(kid), np.array([1, 0, 0, 0], np.float32), \
                np.zeros(3, np.float32)
        pos, inten, dep = backproject(ip_, dp_, q, t, intr, stride,
                                      max_depth)
        keyframes.append({
            "id": kid, "ts": float(ts),
            "pose": [*map(float, q), *map(float, t)],
            "pos": pack_f32(pos), "inten": pack_f32(inten),
            "dep": pack_f32(dep),
        })
    traj = np.array([[ts, *np.asarray(p.t, np.float32)]
                     for ts, p in run["trajectory"]], np.float32)
    if traj.size == 0:
        traj = np.zeros((0, 4), np.float32)
    tvals = ([ts for ts, _ in run["trajectory"]]
             + [k["ts"] for k in keyframes]) or [0.0, 1.0]
    data = {
        "keyframes": keyframes,
        "traj": pack_f32(traj.reshape(-1)),
        "tmin": float(min(tvals)), "tmax": float(max(tvals)),
    }
    return HTML_TEMPLATE.replace("__DATA__", json.dumps(data))


def page_data(html: str) -> dict:
    """The DATA object embedded in a page of ``build_html``."""
    return json.loads(html.split("const DATA = ", 1)[1]
                      .split(";\nfunction", 1)[0])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("run_dir")
    ap.add_argument("--out", default=None)
    ap.add_argument("--stride", type=int, default=2)
    ap.add_argument("--max-depth", type=float, default=8.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device_from_flag(args.device)
    run = load_run(args.run_dir)
    if not run["kf_files"]:
        sys.exit(f"no kf_*_img.png in {args.run_dir} "
                 "(write one with DeepFactors.save_results)")
    html = build_html(run, args.stride, args.max_depth)
    out = args.out or os.path.join(args.run_dir, "viewer.html")
    with open(out, "w") as f:
        f.write(html)
    n_pts = sum(len(base64.b64decode(k["pos"])) // 12
                for k in page_data(html)["keyframes"])
    print(f"wrote {out} ({len(run['kf_files'])} keyframes, "
          f"{n_pts} surfels, {os.path.getsize(out) / 1e6:.1f} MB)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
