"""Interactive URDF inspection as one self-contained HTML file (a copy of
autourdf_tpu.viz_interactive).

A host with no display cannot open a slider window, so this writes one
dependency-free HTML file instead: embedded link meshes and the joint
graph, forward kinematics and a painter's-algorithm canvas renderer in
plain JavaScript, one slider per movable joint, an orbit and zoom camera.
Open it in any browser; nothing is fetched from the network.

Meshes are decimated by vertex clustering so that even marching-cubes link
meshes render interactively (about 3,000 faces a link by default).  The
embedded scene is the JAX module's, number for number.
"""
from __future__ import annotations

import json
import os

import numpy as np

from .urdf.parser import RobotModel, load_urdf


def _decimate(verts: np.ndarray, faces: np.ndarray, target_faces: int) -> tuple[np.ndarray, np.ndarray]:
    """Vertex-clustering decimation: snap to a grid sized to hit ~target_faces."""
    if len(faces) <= target_faces or len(faces) == 0:
        return verts, faces
    lo, hi = verts.min(0), verts.max(0)
    diag = float(np.linalg.norm(hi - lo))
    if diag <= 0:
        return verts, faces
    # face count scales ~ (diag/cell)^2 for a surface; solve for cell
    cell = diag * (len(faces) / max(target_faces, 1)) ** -0.5 / 10.0
    best: tuple[np.ndarray, np.ndarray] | None = None
    for _ in range(8):
        keys = np.floor((verts - lo) / max(cell, 1e-9)).astype(np.int64)
        uniq, inverse = np.unique(keys, axis=0, return_inverse=True)
        f = inverse[faces]
        ok = (f[:, 0] != f[:, 1]) & (f[:, 1] != f[:, 2]) & (f[:, 0] != f[:, 2])
        f = f[ok]
        # drop duplicate faces (same vertex triple in any winding)
        fs = np.sort(f, axis=1)
        _, idx = np.unique(fs, axis=0, return_index=True)
        f = f[np.sort(idx)]
        # new vertex = centroid of each cluster
        nv = np.zeros((len(uniq), 3))
        cnt = np.zeros(len(uniq))
        np.add.at(nv, inverse, verts)
        np.add.at(cnt, inverse, 1)
        nv /= np.maximum(cnt, 1)[:, None]
        best = (nv, f.astype(np.int32))
        if len(f) <= target_faces * 1.2:
            return best
        cell *= 1.5
    return best if best is not None else (verts, faces)


def _scene_json(model: RobotModel, max_faces_per_link: int) -> str:
    links = {}
    for name, link in model.links.items():
        vs, fs = [], []
        base = 0
        for geom in link.geometry("visual"):
            if geom.mesh is None:
                continue
            v = np.asarray(geom.mesh.vertices, dtype=np.float64)
            f = np.asarray(geom.mesh.faces, dtype=np.int64)
            v, f = _decimate(v, f, max_faces_per_link)
            vh = np.concatenate([v, np.ones((len(v), 1))], axis=1)
            v = (vh @ geom.origin.T)[:, :3]
            vs.append(v)
            fs.append(f + base)
            base += len(v)
        if vs:
            v = np.concatenate(vs)
            f = np.concatenate(fs)
        else:
            v = np.zeros((0, 3))
            f = np.zeros((0, 3), dtype=np.int64)
        links[name] = {
            "verts": np.round(v, 5).ravel().tolist(),
            "faces": f.astype(int).ravel().tolist(),
        }
    joints = [
        {
            "name": j.name, "type": j.type, "parent": j.parent, "child": j.child,
            "origin": np.round(j.origin, 6).ravel().tolist(),
            "axis": np.round(np.asarray(j.axis, dtype=float), 6).tolist(),
            "lower": float(j.lower), "upper": float(j.upper),
        }
        for j in model.joints
    ]
    return json.dumps({"name": model.name, "root": model.root,
                       "links": links, "joints": joints},
                      separators=(",", ":"))


_HTML = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>__TITLE__</title>
<style>
 body{margin:0;display:flex;font-family:system-ui,sans-serif;background:#16161e;color:#c8c8d4}
 #c{flex:1;min-width:0;cursor:grab}
 #panel{width:280px;padding:12px;overflow-y:auto;background:#1e1e2a;max-height:100vh;box-sizing:border-box}
 .j{margin-bottom:10px}
 .j label{display:block;font-size:12px;margin-bottom:2px}
 .j input{width:100%}
 .v{float:right;color:#8fd18f;font-variant-numeric:tabular-nums}
 h2{font-size:14px;margin:4px 0 12px}
 button{background:#2d2d40;color:#c8c8d4;border:1px solid #444;border-radius:4px;padding:4px 10px;cursor:pointer;margin-right:6px}
 #hint{font-size:11px;color:#777;margin-top:12px}
 .axchk{font-size:12px;margin-top:8px;display:block}
</style></head><body>
<canvas id="c"></canvas>
<div id="panel"><h2>__TITLE__</h2><div id="sliders"></div>
 <button id="reset">reset</button><button id="spin">spin</button>
 <label class="axchk"><input type="checkbox" id="axes" checked> joint axes</label>
 <div id="hint">drag = orbit &middot; wheel = zoom &middot; shift-drag = pan</div>
</div>
<script>
const SCENE = __SCENE__;
// ---------- tiny mat4 helpers (row-major 4x4 as flat arrays) ----------
const I4=()=>[1,0,0,0, 0,1,0,0, 0,0,1,0, 0,0,0,1];
function mul(a,b){const o=new Array(16);for(let r=0;r<4;r++)for(let c=0;c<4;c++){let s=0;for(let k=0;k<4;k++)s+=a[r*4+k]*b[k*4+c];o[r*4+c]=s;}return o;}
function rotAxis(ax,t){const [x,y,z]=ax,c=Math.cos(t),s=Math.sin(t),C=1-c;
 return [x*x*C+c,x*y*C-z*s,x*z*C+y*s,0, y*x*C+z*s,y*y*C+c,y*z*C-x*s,0, z*x*C-y*s,z*y*C+x*s,z*z*C+c,0, 0,0,0,1];}
function transAxis(ax,d){return [1,0,0,ax[0]*d, 0,1,0,ax[1]*d, 0,0,1,ax[2]*d, 0,0,0,1];}
function apply(m,p){return [m[0]*p[0]+m[1]*p[1]+m[2]*p[2]+m[3], m[4]*p[0]+m[5]*p[1]+m[6]*p[2]+m[7], m[8]*p[0]+m[9]*p[1]+m[10]*p[2]+m[11]];}
function applyRot(m,p){return [m[0]*p[0]+m[1]*p[1]+m[2]*p[2], m[4]*p[0]+m[5]*p[1]+m[6]*p[2], m[8]*p[0]+m[9]*p[1]+m[10]*p[2]];}
// ---------- FK ----------
const movable = SCENE.joints.filter(j=>j.type!=="fixed"&&j.type!=="floating");
const q = {}; movable.forEach(j=>q[j.name]=0);
function linkWorld(){
 const W={}; W[SCENE.root]=I4();
 const pending=SCENE.joints.slice();
 let guard=pending.length*pending.length+1;
 while(pending.length&&guard--){
  const j=pending.shift();
  if(!(j.parent in W)){pending.push(j);continue;}
  let M=mul(W[j.parent],j.origin);
  const n=Math.hypot(...j.axis)||1, ax=j.axis.map(v=>v/n);
  if(j.type==="revolute"||j.type==="continuous") M=mul(M,rotAxis(ax,q[j.name]));
  else if(j.type==="prismatic") M=mul(M,transAxis(ax,q[j.name]));
  W[j.child]=M;
 }
 return W;
}
// ---------- renderer ----------
const cv=document.getElementById("c"),ctx=cv.getContext("2d");
let yaw=0.9,pitch=0.5,dist=0,panX=0,panY=0,spin=false,showAxes=true;
// scene bounds for initial camera
(function(){let lo=[1e9,1e9,1e9],hi=[-1e9,-1e9,-1e9];const W=linkWorld();
 for(const[name,l]of Object.entries(SCENE.links)){const M=W[name]||I4();
  for(let i=0;i<l.verts.length;i+=3){const p=apply(M,[l.verts[i],l.verts[i+1],l.verts[i+2]]);
   for(let k=0;k<3;k++){lo[k]=Math.min(lo[k],p[k]);hi[k]=Math.max(hi[k],p[k]);}}}
 if(lo[0]>hi[0]){lo=[-1,-1,-1];hi=[1,1,1];}
 SCENE.center=[(lo[0]+hi[0])/2,(lo[1]+hi[1])/2,(lo[2]+hi[2])/2];
 dist=2.2*Math.max(1e-3,Math.hypot(hi[0]-lo[0],hi[1]-lo[1],hi[2]-lo[2]));})();
const PALETTE=["#7aa2f7","#9ece6a","#e0af68","#f7768e","#bb9af7","#7dcfff","#ff9e64","#73daca","#c0caf5","#d18616"];
function draw(){
 const w=cv.clientWidth,h=cv.clientHeight;
 if(cv.width!==w||cv.height!==h){cv.width=w;cv.height=h;}
 ctx.fillStyle="#16161e";ctx.fillRect(0,0,w,h);
 const cy=Math.cos(yaw),sy=Math.sin(yaw),cp=Math.cos(pitch),sp=Math.sin(pitch);
 // camera: orbit about z-up center
 const view=p=>{
  let x=p[0]-SCENE.center[0],y=p[1]-SCENE.center[1],z=p[2]-SCENE.center[2];
  let x1=cy*x+sy*y, y1=-sy*x+cy*y;           // yaw about z
  let y2=cp*y1+sp*z, z2=-sp*y1+cp*z;          // pitch
  return [x1+panX, z2+panY, y2+dist];         // z-up -> screen-y, depth=y2
 };
 const f=0.9*Math.min(w,h)/Math.max(dist,1e-6)*1.2;
 const proj=v=>[w/2+f*v[0]*dist/Math.max(v[2],1e-6), h/2-f*v[1]*dist/Math.max(v[2],1e-6)];
 const W=linkWorld();
 const tris=[];
 const L=[0.35,-0.5,0.75];  // light dir
 let li=0;
 for(const[name,l]of Object.entries(SCENE.links)){
  const M=W[name]||I4(); const col=PALETTE[li++%PALETTE.length];
  const vp=[];
  for(let i=0;i<l.verts.length;i+=3) vp.push(view(apply(M,[l.verts[i],l.verts[i+1],l.verts[i+2]])));
  for(let i=0;i<l.faces.length;i+=3){
   const a=vp[l.faces[i]],b=vp[l.faces[i+1]],c=vp[l.faces[i+2]];
   if(!a||!b||!c)continue;
   const z=(a[2]+b[2]+c[2])/3; if(z<=1e-6)continue;
   const u=[b[0]-a[0],b[1]-a[1],b[2]-a[2]],v=[c[0]-a[0],c[1]-a[1],c[2]-a[2]];
   const n=[u[1]*v[2]-u[2]*v[1],u[2]*v[0]-u[0]*v[2],u[0]*v[1]-u[1]*v[0]];
   const nn=Math.hypot(...n)||1;
   const lam=Math.abs((n[0]*L[0]+n[1]*L[1]+n[2]*L[2])/nn);
   tris.push([z,a,b,c,col,0.35+0.65*lam]);
  }
 }
 tris.sort((p,qq)=>qq[0]-p[0]);
 for(const[,a,b,c,col,lam]of tris){
  const pa=proj(a),pb=proj(b),pc=proj(c);
  ctx.beginPath();ctx.moveTo(pa[0],pa[1]);ctx.lineTo(pb[0],pb[1]);ctx.lineTo(pc[0],pc[1]);ctx.closePath();
  const r=parseInt(col.slice(1,3),16),g=parseInt(col.slice(3,5),16),bl=parseInt(col.slice(5,7),16);
  ctx.fillStyle=`rgb(${r*lam|0},${g*lam|0},${bl*lam|0})`;
  ctx.fill();
 }
 if(showAxes){
  ctx.lineWidth=2;
  for(const j of movable){
   const Mp=W[j.parent]; if(!Mp)continue;
   const M=mul(Mp,j.origin);
   const o=apply(M,[0,0,0]);
   const n=Math.hypot(...j.axis)||1;
   const axw=applyRot(M,j.axis.map(v=>v/n));
   const s=dist*0.06;
   const p1=view([o[0]-axw[0]*s,o[1]-axw[1]*s,o[2]-axw[2]*s]);
   const p2=view([o[0]+axw[0]*s,o[1]+axw[1]*s,o[2]+axw[2]*s]);
   if(p1[2]<=1e-6||p2[2]<=1e-6)continue;
   const a=proj(p1),b=proj(p2);
   ctx.strokeStyle="#ff5370";ctx.beginPath();ctx.moveTo(a[0],a[1]);ctx.lineTo(b[0],b[1]);ctx.stroke();
  }
 }
}
// ---------- UI ----------
const sl=document.getElementById("sliders");
movable.forEach(j=>{
 const lo=(j.lower<j.upper)?j.lower:-3.1416, hi=(j.lower<j.upper)?j.upper:3.1416;
 const d=document.createElement("div");d.className="j";
 d.innerHTML=`<label>${j.name} <span class="v" id="v_${j.name}">0.00</span></label>
  <input type="range" min="${lo}" max="${hi}" step="0.001" value="0" id="s_${j.name}">`;
 sl.appendChild(d);
 const inp=d.querySelector("input");
 inp.addEventListener("input",()=>{q[j.name]=parseFloat(inp.value);
  document.getElementById("v_"+j.name).textContent=(+inp.value).toFixed(2);draw();});
});
document.getElementById("reset").onclick=()=>{movable.forEach(j=>{q[j.name]=0;
 document.getElementById("s_"+j.name).value=0;document.getElementById("v_"+j.name).textContent="0.00";});draw();};
document.getElementById("spin").onclick=()=>{spin=!spin;if(spin)tick();};
document.getElementById("axes").onchange=e=>{showAxes=e.target.checked;draw();};
function tick(){if(!spin)return;yaw+=0.01;draw();requestAnimationFrame(tick);}
let drag=null;
cv.addEventListener("mousedown",e=>{drag=[e.clientX,e.clientY,e.shiftKey];cv.style.cursor="grabbing";});
window.addEventListener("mouseup",()=>{drag=null;cv.style.cursor="grab";});
window.addEventListener("mousemove",e=>{if(!drag)return;
 const dx=e.clientX-drag[0],dy=e.clientY-drag[1];drag[0]=e.clientX;drag[1]=e.clientY;
 if(drag[2]){panX+=dx*dist*0.0015;panY-=dy*dist*0.0015;}
 else{yaw+=dx*0.008;pitch=Math.max(-1.5,Math.min(1.5,pitch+dy*0.008));}
 draw();});
cv.addEventListener("wheel",e=>{e.preventDefault();dist*=Math.exp(e.deltaY*0.001);draw();},{passive:false});
window.addEventListener("resize",draw);
draw();
</script></body></html>
"""


def export_interactive_html(
    urdf_path: str,
    out_path: str,
    asset_root: str | None = None,
    max_faces_per_link: int = 3000,
) -> str:
    """Write a self-contained interactive viewer for ``urdf_path``.

    Returns ``out_path``.  The file embeds decimated link meshes and runs
    FK + rendering in the browser; no network access or Python needed to
    view it.
    """
    model = load_urdf(urdf_path, asset_root=asset_root, load_meshes=True)
    scene = _scene_json(model, max_faces_per_link)
    html = (_HTML
            .replace("__TITLE__", model.name or os.path.basename(urdf_path))
            .replace("__SCENE__", scene))
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        f.write(html)
    return out_path
