"""Live viewer: browser-based analog of the reference's Pangolin stack.

(reference: Viewer::RunWithLine spawned as thread 4 with menu toggles for
points / lines / planes / keyframes / covisibility graph / Manhattan axes
and camera-follow, src/Viewer.cc:169 + src/System.cc:108-113;
FrameDrawer::DrawFrame overlays tracked features on the current image,
src/FrameDrawer.cc:38; MapDrawer renders the landmark tables,
src/MapDrawer.cc:42-304.)

Port of `hfvo_tpu.viz.live` (numpy, PIL and stdlib, copied); the current
frame's line segments are read from the tracker's device-resident line
feed. A headless host has no GL stack, so the equivalent here is an HTTP
viewer:

- the tracker publishes **zero-copy references** to its latest host arrays
  (one pointer swap per frame — nothing is rendered on the hot path);
- a daemon `ThreadingHTTPServer` renders on demand, per request:
  `/state.json` (current frame as base64 PNG + keypoint/segment overlays),
  `/map.json` (points / lines / planes / keyframe frusta / covisibility
  edges / Manhattan axes / camera trajectory), and `/` (a vanilla-JS page
  with a 2D overlay canvas and an orbitable 3D canvas with the same menu
  toggles as the reference viewer).

The torn-read hazard of rendering while the tracker mutates its tables is
accepted exactly like the reference accepts stale drawer state between
mutex updates — landmark tables are append+mask structures, so a reader
sees at worst a frame-old mask with new rows.
"""
from __future__ import annotations

import base64
import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np


def _png_gray(gray: np.ndarray) -> bytes:
    """Encode (H, W) uint8 as PNG (PIL, as the TUM loader decodes)."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(gray, mode="L").save(buf, format="PNG", compress_level=1)
    return buf.getvalue()


class LiveViewer:
    """Publish/serve split: `publish()` swaps references (called per frame
    by VOSystem), the HTTP thread renders JSON/PNG only when a browser
    asks."""

    def __init__(self, tracker, port: int = 0, host: str = "127.0.0.1"):
        self.tracker = tracker
        tracker.viz_enabled = True
        self._latest: dict = {}
        self._lock = threading.Lock()
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, body: bytes, ctype: str):
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                try:
                    if self.path.startswith("/state.json"):
                        self._send(
                            json.dumps(viewer.state_dict()).encode(),
                            "application/json",
                        )
                    elif self.path.startswith("/map.json"):
                        self._send(
                            json.dumps(viewer.map_dict()).encode(),
                            "application/json",
                        )
                    elif self.path == "/":
                        self._send(_PAGE.encode(), "text/html")
                    else:
                        self.send_response(404)
                        self.end_headers()
                except (BrokenPipeError, ConnectionResetError):
                    pass

        self.server = ThreadingHTTPServer((host, port), Handler)
        self.port = self.server.server_address[1]
        self._thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------

    def publish(self, gray: np.ndarray, res) -> None:
        """Reference swap only — no copies, no encoding (called per frame)."""
        with self._lock:
            self._latest = dict(
                gray=gray,
                state=str(getattr(res, "state", "")),
                n_matches=int(getattr(res, "n_matches", 0)),
                frame_id=int(self.tracker.frame_id),
                is_keyframe=bool(getattr(res, "is_keyframe", False)),
            )

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()

    # ------------------------------------------------------------------

    def state_dict(self) -> dict:
        """Current-frame overlay payload (reference: FrameDrawer::DrawFrame
        draws tracked keypoints green and lines red on the current image +
        a status text bar, src/FrameDrawer.cc:38-322)."""
        with self._lock:
            latest = dict(self._latest)
        out = {
            "frame_id": latest.get("frame_id", -1),
            "state": latest.get("state", "NOT_INITIALIZED"),
            "n_matches": latest.get("n_matches", 0),
            "is_keyframe": latest.get("is_keyframe", False),
        }
        gray = latest.get("gray")
        if gray is not None:
            g = np.asarray(gray)
            if g.dtype != np.uint8:
                g = np.clip(g, 0, 255).astype(np.uint8)
            out["png"] = base64.b64encode(_png_gray(g)).decode()
        kp = self.tracker._last_viz_kp
        if kp is not None:
            uv, matched, valid = kp
            v = np.asarray(valid, bool)
            out["kp"] = np.asarray(uv)[v].round(1).tolist()
            out["kp_matched"] = np.asarray(matched)[v].tolist()
        feed = self.tracker._prev_line_feed
        if feed is not None:
            dev = feed["dev"]
            v = dev.valid.cpu().numpy()
            out["seg0"] = dev.p0.cpu().numpy()[v].round(1).tolist()
            out["seg1"] = dev.p1.cpu().numpy()[v].round(1).tolist()
            out["seg_matched"] = (np.asarray(feed["gid"])[v] >= 0).tolist()
        return out

    def map_dict(self, max_points: int = 4000) -> dict:
        """Map payload (reference: MapDrawer::DrawMapPoints :42, DrawMapLines
        :82, DrawManhAxis :142, DrawKeyFrames + covisibility graph :208,
        DrawCurrentCamera :304)."""
        tr = self.tracker
        vm = tr.vomap
        out: dict = {"T_cw": np.asarray(tr.T_cw).tolist()}
        pv = np.nonzero(vm.points.valid)[0]
        if len(pv) > max_points:
            pv = pv[:: len(pv) // max_points + 1]
        out["points"] = vm.points.X_w[pv].round(3).tolist()
        lv = np.nonzero(vm.lines.valid)[0]
        out["lines0"] = vm.lines.X0_w[lv].round(3).tolist()
        out["lines1"] = vm.lines.X1_w[lv].round(3).tolist()
        plv = np.nonzero(vm.planes.valid)[0]
        out["plane_pi"] = vm.planes.pi_w[plv].round(4).tolist()
        out["plane_c"] = vm.planes.centroid_w[plv].round(3).tolist()
        ks = np.nonzero(vm.keyframes.valid)[0]
        T_wc = np.linalg.inv(vm.keyframes.T_cw[ks]) if len(ks) else np.zeros((0, 4, 4))
        out["kf_T_wc"] = T_wc.round(4).tolist()
        # Covisibility graph edges (slot pairs, strongest first) — same
        # source data as MapDrawer's graph pass (src/MapDrawer.cc:208).
        edges = []
        for ki, k in enumerate(ks):
            slots, w = vm.covisibility(int(k))
            for s, wt in zip(slots, w):
                if s > k and wt >= 15:
                    edges.append([int(k), int(s)])
        slot_to_idx = {int(k): i for i, k in enumerate(ks)}
        out["covis"] = [
            [slot_to_idx[a], slot_to_idx[b]]
            for a, b in edges
            if a in slot_to_idx and b in slot_to_idx
        ]
        if tr.manh_valid:
            out["manh_axes"] = np.asarray(tr.R_wm).round(4).tolist()
        return out


_PAGE = """<!doctype html>
<meta charset="utf-8"><title>hfvo_tpu_torch live viewer</title>
<style>
body{background:#111;color:#ddd;font:13px sans-serif;margin:0;display:flex;flex-wrap:wrap}
canvas{background:#000;margin:4px}
#menu{padding:8px;min-width:160px}
label{display:block;margin:2px 0}
#status{color:#8f8;white-space:pre}
</style>
<div id=menu>
  <b>hfvo_tpu_torch</b>
  <div id=status>waiting...</div>
  <label><input type=checkbox id=showPoints checked>Show Points</label>
  <label><input type=checkbox id=showLines checked>Show Lines</label>
  <label><input type=checkbox id=showPlanes checked>Show Planes</label>
  <label><input type=checkbox id=showKFs checked>Show KeyFrames</label>
  <label><input type=checkbox id=showGraph checked>Show Graph</label>
  <label><input type=checkbox id=showManh checked>Show Manh Axis</label>
  <label><input type=checkbox id=follow checked>Follow Camera</label>
</div>
<canvas id=frame width=640 height=480></canvas>
<canvas id=map width=640 height=480></canvas>
<script>
const fc=document.getElementById('frame'),fx=fc.getContext('2d');
const mc=document.getElementById('map'),mx=mc.getContext('2d');
let img=new Image(),yaw=0.5,pitch=0.4,dist=6,center=[0,0,2],drag=null;
mc.onmousedown=e=>drag=[e.clientX,e.clientY];
window.onmouseup=()=>drag=null;
window.onmousemove=e=>{if(!drag)return;yaw+=(e.clientX-drag[0])*0.01;pitch+=(e.clientY-drag[1])*0.01;drag=[e.clientX,e.clientY];};
mc.onwheel=e=>{dist*=Math.exp(e.deltaY*0.001);e.preventDefault();};
function proj(p){
  const cy=Math.cos(yaw),sy=Math.sin(yaw),cp=Math.cos(pitch),sp=Math.sin(pitch);
  let x=p[0]-center[0],y=p[1]-center[1],z=p[2]-center[2];
  let x1=cy*x+sy*z, z1=-sy*x+cy*z;
  let y1=cp*y-sp*z1, z2=sp*y+cp*z1+dist;
  if(z2<0.1)return null;
  return [320+420*x1/z2, 240+420*y1/z2];
}
function seg(a,b,color){const pa=proj(a),pb=proj(b);if(!pa||!pb)return;
  mx.strokeStyle=color;mx.beginPath();mx.moveTo(pa[0],pa[1]);mx.lineTo(pb[0],pb[1]);mx.stroke();}
function camPos(T){ // T = T_wc 4x4 -> position + axes
  return {p:[T[0][3],T[1][3],T[2][3]],
          x:[T[0][0],T[1][0],T[2][0]],y:[T[0][1],T[1][1],T[2][1]],z:[T[0][2],T[1][2],T[2][2]]};}
function frustum(c,s,color){
  const p=c.p, f=s*1.6;
  const corners=[-1,1].flatMap(u=>[-1,1].map(v=>
    [p[0]+f*c.z[0]+u*s*c.x[0]+v*s*0.7*c.y[0],
     p[1]+f*c.z[1]+u*s*c.x[1]+v*s*0.7*c.y[1],
     p[2]+f*c.z[2]+u*s*c.x[2]+v*s*0.7*c.y[2]]));
  for(const q of corners)seg(p,q,color);
  seg(corners[0],corners[1],color);seg(corners[1],corners[3],color);
  seg(corners[3],corners[2],color);seg(corners[2],corners[0],color);
}
function inv(T){ // invert SE3 given T_cw row-major
  const R=[[T[0][0],T[0][1],T[0][2]],[T[1][0],T[1][1],T[1][2]],[T[2][0],T[2][1],T[2][2]]];
  const t=[T[0][3],T[1][3],T[2][3]];
  const Rt=[[R[0][0],R[1][0],R[2][0]],[R[0][1],R[1][1],R[2][1]],[R[0][2],R[1][2],R[2][2]]];
  const ti=Rt.map(r=>-(r[0]*t[0]+r[1]*t[1]+r[2]*t[2]));
  return [[...Rt[0],ti[0]],[...Rt[1],ti[1]],[...Rt[2],ti[2]],[0,0,0,1]];
}
async function tick(){
  try{
    const s=await (await fetch('state.json')).json();
    document.getElementById('status').textContent=
      `frame ${s.frame_id}  ${s.state}\\nmatches ${s.n_matches}`+(s.is_keyframe?'  [KF]':'');
    if(s.png){img.src='data:image/png;base64,'+s.png;
      img.onload=()=>{fx.drawImage(img,0,0);
        if(s.kp){for(let i=0;i<s.kp.length;i++){
          fx.strokeStyle=s.kp_matched[i]?'#0f0':'#555';
          fx.strokeRect(s.kp[i][0]-3,s.kp[i][1]-3,6,6);}}
        if(s.seg0){for(let i=0;i<s.seg0.length;i++){
          fx.strokeStyle=s.seg_matched[i]?'#f33':'#733';
          fx.beginPath();fx.moveTo(s.seg0[i][0],s.seg0[i][1]);
          fx.lineTo(s.seg1[i][0],s.seg1[i][1]);fx.stroke();}}};}
    const m=await (await fetch('map.json')).json();
    mx.fillStyle='#000';mx.fillRect(0,0,640,480);
    const cam=camPos(inv(m.T_cw));
    if(document.getElementById('follow').checked)center=cam.p;
    if(document.getElementById('showPoints').checked){mx.fillStyle='#aaa';
      for(const p of m.points){const q=proj(p);if(q)mx.fillRect(q[0],q[1],2,2);}}
    if(document.getElementById('showLines').checked)
      for(let i=0;i<m.lines0.length;i++)seg(m.lines0[i],m.lines1[i],'#f55');
    if(document.getElementById('showPlanes').checked&&m.plane_c)
      for(let i=0;i<m.plane_c.length;i++){const c=m.plane_c[i],n=m.plane_pi[i];
        seg(c,[c[0]+0.3*n[0],c[1]+0.3*n[1],c[2]+0.3*n[2]],'#5cf');
        const q=proj(c);if(q){mx.strokeStyle='#5cf';mx.strokeRect(q[0]-5,q[1]-5,10,10);}}
    if(document.getElementById('showKFs').checked)
      for(const T of m.kf_T_wc)frustum(camPos(T),0.05,'#46f');
    if(document.getElementById('showGraph').checked&&m.covis)
      for(const [a,b] of m.covis)
        seg(camPos(m.kf_T_wc[a]).p,camPos(m.kf_T_wc[b]).p,'#284');
    if(document.getElementById('showManh').checked&&m.manh_axes){
      const o=cam.p,A=m.manh_axes,cl=['#f00','#0f0','#00f'];
      for(let a=0;a<3;a++)seg(o,[o[0]+0.5*A[0][a],o[1]+0.5*A[1][a],o[2]+0.5*A[2][a]],cl[a]);}
    frustum(cam,0.08,'#0f0');
  }catch(e){}
  setTimeout(tick,200);
}
tick();
</script>
"""
