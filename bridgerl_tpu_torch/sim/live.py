"""Live interactive replay viewport in the browser.

Counterpart of ``bridgerl_tpu/sim/live.py``. The reference replays motion
into a live Omniverse viewport (play_g1_npy.py:194-210); here host numpy FK
(``fk_numpy``) turns a (T, 29) joint trajectory into (T, L, 3) link
positions (or collision capsules, or mesh poses), and one self-contained
HTML page (no CDN) draws them on a canvas with an orbit camera, play and
pause, scrubbing and speed; ``serve_viewer`` serves it on localhost. The
page is the JAX package's, character for character.

``cli/live_viewer.py`` builds the page and serves it.
"""

from __future__ import annotations

import http.server
import json
import socketserver
from typing import Optional

import numpy as np

from .kinematics import fk_numpy
from .mesh import decimate
from .urdf import KinematicChain, rpy_to_matrix

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title>
<style>
 body {{ margin:0; background:#14161a; color:#cfd4dc; font:13px sans-serif; }}
 #bar {{ display:flex; gap:10px; align-items:center; padding:8px 12px; }}
 #cv {{ display:block; margin:auto; background:#1b1e24; border-radius:6px; }}
 button,select {{ background:#2a2e36; color:#cfd4dc; border:1px solid #3a3f49;
                  border-radius:4px; padding:4px 10px; cursor:pointer; }}
 input[type=range] {{ flex:1; }}
 #hud {{ min-width:140px; text-align:right; font-variant-numeric:tabular-nums; }}
</style></head><body>
<div id="bar">
 <button id="play">&#9208;</button>
 <input id="scrub" type="range" min="0" max="{tmax}" value="0" step="1">
 <select id="speed"><option>0.25</option><option>0.5</option>
  <option selected>1</option><option>2</option><option>4</option></select>
 <span id="hud"></span>
</div>
<canvas id="cv" width="840" height="620"></canvas>
<script>
const FRAMES = {frames};      // (T, L, 3) link positions
const PARENT = {parent};      // parent link index, -1 for root
const VOLS = {vols};          // (T, P, 7) world capsules or null (skeleton)
const MESHES = {meshes};      // [{{li, color, tris:[x,y,z]x3xF}}] or null
const ROTS = {rots};          // (T, L, 9) row-major link rotations or null
const FPS = {fps};
const T = FRAMES.length, L = PARENT.length;
let frame = 0, playing = true, speed = 1, acc = 0, last = null;
let azim = 0.6, elev = 0.35, zoom = 1.0;           // orbit camera state
const cv = document.getElementById('cv'), ctx = cv.getContext('2d');
const scrub = document.getElementById('scrub'), hud = document.getElementById('hud');
const playBtn = document.getElementById('play');

// center/scale once from the whole trajectory so the camera doesn't swim
let mn = [1e9,1e9,1e9], mx = [-1e9,-1e9,-1e9];
for (const f of FRAMES) for (const p of f) for (let k = 0; k < 3; k++)
  {{ mn[k] = Math.min(mn[k], p[k]); mx[k] = Math.max(mx[k], p[k]); }}
const C = [0,1,2].map(k => (mn[k]+mx[k])/2);
const R = Math.max(mx[0]-mn[0], mx[1]-mn[1], mx[2]-mn[2]) / 2 + 0.2;

function project(p) {{
  const x = p[0]-C[0], y = p[1]-C[1], z = p[2]-C[2];
  const ca = Math.cos(azim), sa = Math.sin(azim);
  const ce = Math.cos(elev), se = Math.sin(elev);
  const u = -sa*x + ca*y;                     // screen right
  const v = -se*(ca*x + sa*y) + ce*z;        // screen up
  const s = Math.min(cv.width, cv.height) * 0.42 * zoom / R;
  return [cv.width/2 + u*s, cv.height/2 + 30 - v*s];
}}

function draw() {{
  ctx.clearRect(0, 0, cv.width, cv.height);
  // ground grid at z = min
  ctx.strokeStyle = '#262b33'; ctx.lineWidth = 1;
  for (let i = -4; i <= 4; i++) {{
    const a = project([C[0]+i*R/4, C[1]-R, mn[2]]), b = project([C[0]+i*R/4, C[1]+R, mn[2]]);
    const c = project([C[0]-R, C[1]+i*R/4, mn[2]]), d = project([C[0]+R, C[1]+i*R/4, mn[2]]);
    ctx.beginPath(); ctx.moveTo(a[0],a[1]); ctx.lineTo(b[0],b[1]);
    ctx.moveTo(c[0],c[1]); ctx.lineTo(d[0],d[1]); ctx.stroke();
  }}
  const f = FRAMES[frame], pts = f.map(project);
  if (MESHES && ROTS) {{
    // vendor visual meshes: link-frame triangles posed by FK world
    // rotations, flat Lambert shading, painter-sorted across all links
    const ca = Math.cos(azim), sa = Math.sin(azim);
    const ce = Math.cos(elev), se = Math.sin(elev);
    const depth = (x,y,z) => ce*(ca*(x-C[0]) + sa*(y-C[1])) + se*(z-C[2]);
    const lx = 0.5, ly = -0.3, lz = 0.81;      // fixed light direction
    const faces = [];
    const rot = ROTS[frame];
    for (const m of MESHES) {{
      const p = f[m.li], R = rot[m.li], tr = m.tris;
      for (let i = 0; i < tr.length; i += 9) {{
        const w = new Array(9);
        for (let k = 0; k < 3; k++) {{
          const x = tr[i+3*k], y = tr[i+3*k+1], z = tr[i+3*k+2];
          w[3*k]   = R[0]*x + R[1]*y + R[2]*z + p[0];
          w[3*k+1] = R[3]*x + R[4]*y + R[5]*z + p[1];
          w[3*k+2] = R[6]*x + R[7]*y + R[8]*z + p[2];
        }}
        const e1x = w[3]-w[0], e1y = w[4]-w[1], e1z = w[5]-w[2];
        const e2x = w[6]-w[0], e2y = w[7]-w[1], e2z = w[8]-w[2];
        let nx = e1y*e2z - e1z*e2y, ny = e1z*e2x - e1x*e2z,
            nz = e1x*e2y - e1y*e2x;
        const nn = Math.hypot(nx, ny, nz) || 1e-9;
        const shade = 0.35 + 0.65*Math.abs((nx*lx + ny*ly + nz*lz)/nn);
        faces.push([depth((w[0]+w[3]+w[6])/3, (w[1]+w[4]+w[7])/3,
                          (w[2]+w[5]+w[8])/3), w, m.color, shade]);
      }}
    }}
    faces.sort((a, b) => a[0] - b[0]);
    for (const [, w, col, sh] of faces) {{
      const a = project([w[0],w[1],w[2]]), b = project([w[3],w[4],w[5]]),
            c = project([w[6],w[7],w[8]]);
      ctx.fillStyle = `rgb(${{col[0]*sh*255|0}},${{col[1]*sh*255|0}},` +
                      `${{col[2]*sh*255|0}})`;
      ctx.beginPath(); ctx.moveTo(a[0],a[1]); ctx.lineTo(b[0],b[1]);
      ctx.lineTo(c[0],c[1]); ctx.closePath(); ctx.fill();
    }}
  }} else if (VOLS) {{
    // volumetric: each row is [x1,y1,z1,x2,y2,z2,radius] — a world capsule
    // (sphere if the endpoints coincide); painter's algorithm back-to-front
    const ca = Math.cos(azim), sa = Math.sin(azim);
    const ce = Math.cos(elev), se = Math.sin(elev);
    const depth = p => ce*(ca*(p[0]-C[0]) + sa*(p[1]-C[1])) + se*(p[2]-C[2]);
    const s = Math.min(cv.width, cv.height) * 0.42 * zoom / R;
    const vf = VOLS[frame];
    const order = vf.map((v, i) =>
      [depth([(v[0]+v[3])/2, (v[1]+v[4])/2, (v[2]+v[5])/2]), i])
      .sort((a, b) => a[0] - b[0]);
    const dmin = order[0][0], dmax = order[order.length-1][0];
    for (const [d, i] of order) {{
      const v = vf[i];
      const a = project([v[0], v[1], v[2]]), b = project([v[3], v[4], v[5]]);
      const light = 38 + 26 * (d - dmin) / Math.max(dmax - dmin, 1e-6);
      ctx.strokeStyle = `hsl(212, 62%, ${{light}}%)`;
      ctx.lineWidth = Math.max(2, 2 * v[6] * s);
      ctx.lineCap = 'round';
      ctx.beginPath(); ctx.moveTo(a[0], a[1]); ctx.lineTo(b[0], b[1]);
      ctx.stroke();
    }}
  }} else {{
    ctx.strokeStyle = '#4f9cf7'; ctx.lineWidth = 2.5;
    ctx.beginPath();
    for (let i = 1; i < L; i++) {{
      const p = pts[PARENT[i]], q = pts[i];
      ctx.moveTo(p[0], p[1]); ctx.lineTo(q[0], q[1]);
    }}
    ctx.stroke();
    ctx.fillStyle = '#e66a6a';
    for (const p of pts) {{ ctx.beginPath(); ctx.arc(p[0], p[1], 3, 0, 7); ctx.fill(); }}
  }}
  scrub.value = frame;
  hud.textContent = `${{(frame/FPS).toFixed(2)}}s  ${{frame+1}}/${{T}}`;
}}

function tick(ts) {{
  if (last === null) last = ts;
  if (playing) {{
    acc += (ts - last) / 1000 * FPS * speed;
    const step = Math.floor(acc);
    if (step > 0) {{ frame = (frame + step) % T; acc -= step; }}
  }}
  last = ts; draw(); requestAnimationFrame(tick);
}}

playBtn.onclick = () => {{ playing = !playing; playBtn.innerHTML = playing ? '&#9208;' : '&#9205;'; }};
scrub.oninput = () => {{ frame = +scrub.value; playing = false; playBtn.innerHTML = '&#9205;'; }};
document.getElementById('speed').onchange = e => speed = +e.target.value;
let drag = null;
cv.onmousedown = e => drag = [e.clientX, e.clientY];
window.onmouseup = () => drag = null;
window.onmousemove = e => {{
  if (!drag) return;
  azim += (e.clientX - drag[0]) * 0.01;
  elev = Math.max(-1.5, Math.min(1.5, elev + (e.clientY - drag[1]) * 0.01));
  drag = [e.clientX, e.clientY];
}};
cv.onwheel = e => {{ e.preventDefault(); zoom = Math.max(0.2, Math.min(5, zoom * (e.deltaY < 0 ? 1.1 : 0.9))); }};
window.onkeydown = e => {{
  if (e.code === 'Space') {{ e.preventDefault(); playBtn.onclick(); }}
  if (e.code === 'ArrowRight') {{ frame = (frame + 1) % T; playing = false; }}
  if (e.code === 'ArrowLeft') {{ frame = (frame - 1 + T) % T; playing = false; }}
}};
requestAnimationFrame(tick);
</script></body></html>
"""


def motion_to_frames(chain: KinematicChain, q_frames: np.ndarray) -> np.ndarray:
    """(T, num_actuated) joint angles -> (T, L, 3) link positions (host FK;
    T * L is small)."""
    out = np.empty((q_frames.shape[0], chain.num_links, 3), np.float32)
    for t, q in enumerate(q_frames):
        out[t] = fk_numpy(chain, q)[0]
    return out


def motion_to_volumes(chain: KinematicChain, q_frames: np.ndarray,
                      prims) -> np.ndarray:
    """(T, A) joint angles + collision primitives -> (T, P, 7) world capsules.

    Each row is [x1, y1, z1, x2, y2, z2, radius] — the browser page draws it
    as a round-capped thick line (a capsule in screen space; endpoints equal
    = sphere). Cylinders extend along their collision frame's Z; boxes are
    approximated by a capsule along their longest axis with the mean of the
    other two half-extents as radius (the G1 URDF has no box collisions).
    """
    by_link = {name: i for i, name in enumerate(chain.link_names)}
    prims = [p for p in prims if p.link in by_link]
    out = np.empty((q_frames.shape[0], len(prims), 7), np.float32)
    for t, q in enumerate(q_frames):
        pos, rot = fk_numpy(chain, q)
        for pi, prim in enumerate(prims):
            li = by_link[prim.link]
            R = rot[li] @ rpy_to_matrix(prim.origin_rpy)
            c = pos[li] + rot[li] @ np.asarray(prim.origin_pos)
            if prim.kind == "sphere":
                a = b = c
                r = prim.size[0]
            elif prim.kind == "cylinder":
                r, length = prim.size
                half = R @ np.array([0.0, 0.0, length / 2])
                a, b = c - half, c + half
            else:  # box
                size = np.asarray(prim.size)
                ax = int(np.argmax(size))
                direction = np.zeros(3)
                direction[ax] = size[ax] / 2
                half = R @ direction
                a, b = c - half, c + half
                r = float(np.delete(size, ax).mean() / 2)
            out[t, pi] = [*a, *b, r]
    return out


def motion_to_poses(chain: KinematicChain, q_frames: np.ndarray):
    """(T, A) joint angles -> ((T, L, 3) positions, (T, L, 3, 3) rotations)
    via host numpy FK — both halves of the world pose the mesh viewer needs."""
    T = q_frames.shape[0]
    pos = np.empty((T, chain.num_links, 3), np.float32)
    rot = np.empty((T, chain.num_links, 3, 3), np.float32)
    for t, q in enumerate(q_frames):
        pos[t], rot[t] = fk_numpy(chain, q)
    return pos, rot


def meshes_payload(chain: KinematicChain, meshes,
                   total_budget: int = 6000) -> list:
    """sim/mesh.py LinkMesh list -> JSON-ready per-link triangle payload.

    Re-decimates to a browser-friendly budget (the page fills every face as
    a canvas path per frame; ~6k faces keeps 25+ fps on a laptop). Triangles
    stay in the LINK frame — the page poses them per frame with the FK
    rotations, so the payload is frame-count independent.
    """
    by_link = {name: i for i, name in enumerate(chain.link_names)}
    total = sum(m.tris.shape[0] for m in meshes) or 1
    out = []
    for m in meshes:
        li = by_link.get(m.link)
        if li is None:
            continue
        budget = max(60, int(total_budget * m.tris.shape[0] / total))
        tris = decimate(m.tris, budget)
        out.append({
            "li": li,
            "color": [round(float(c), 3) for c in m.color],
            "tris": np.round(tris.reshape(-1), 4).tolist(),
        })
    return out


def build_viewer_html(chain: KinematicChain, positions: np.ndarray,
                      fps: float = 50.0, title: str = "bridgerl replay",
                      volumes: Optional[np.ndarray] = None,
                      meshes: Optional[list] = None,
                      rotations: Optional[np.ndarray] = None) -> str:
    """Self-contained live-viewport page for (T, L, 3) link positions.

    ``volumes``: optional (T, P, 7) world capsules from motion_to_volumes —
    the page then renders the body's collision volumes instead of the line
    skeleton. ``meshes`` (from meshes_payload) + ``rotations``
    ((T, L, 3, 3) from motion_to_poses) switch to the vendor visual-mesh
    body — the interactive twin of sim/render.draw_meshes.
    """
    positions = np.asarray(positions, np.float64)
    if positions.ndim != 3 or positions.shape[0] == 0:
        # a (1,) trajectory resamples to 0 frames — fail with a diagnosis
        # instead of emitting a page whose JS dies on FRAMES[0]
        raise ValueError(
            f"need (T>=1, L, 3) link positions, got {positions.shape} "
            f"(single-frame inputs resample to zero frames)")
    frames = np.round(positions, 4).tolist()
    if volumes is not None:
        volumes = np.asarray(volumes, np.float64)
        if volumes.ndim != 3 or volumes.shape[0] != positions.shape[0] \
                or volumes.shape[2] != 7:
            raise ValueError(
                f"volumes must be (T={positions.shape[0]}, P, 7), "
                f"got {volumes.shape}")
        vols = json.dumps(np.round(volumes, 4).tolist())
    else:
        vols = "null"
    if meshes is not None:
        if rotations is None:
            raise ValueError("meshes need rotations (motion_to_poses)")
        rotations = np.asarray(rotations, np.float64)
        if rotations.shape != (positions.shape[0], positions.shape[1], 3, 3):
            raise ValueError(
                f"rotations must be (T, L, 3, 3) matching positions, "
                f"got {rotations.shape}")
        meshes_js = json.dumps(meshes)
        rots_js = json.dumps(
            np.round(rotations.reshape(rotations.shape[0],
                                       rotations.shape[1], 9), 4).tolist())
    else:
        meshes_js = rots_js = "null"
    return _PAGE.format(
        title=title, frames=json.dumps(frames), vols=vols,
        meshes=meshes_js, rots=rots_js,
        parent=json.dumps(chain.parent_index.tolist()),
        fps=float(fps), tmax=len(frames) - 1)


def serve_viewer(html: str, port: int = 8731,
                 max_requests: Optional[int] = None) -> None:
    """Serve the page on localhost (the 'live' in live viewport).

    Blocks; Ctrl-C to stop. `max_requests` bounds the serve loop for tests.
    """
    payload = html.encode()

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802  (stdlib API name)
            self.send_response(200)
            self.send_header("Content-Type", "text/html; charset=utf-8")
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def log_message(self, *a):
            pass

    class _Server(socketserver.TCPServer):
        # must be a CLASS attribute: TCPServer.__init__ binds the socket, so
        # setting it on the instance afterwards never applies SO_REUSEADDR
        # (relaunch within TIME_WAIT would fail with EADDRINUSE)
        allow_reuse_address = True

    with _Server(("127.0.0.1", port), Handler) as srv:
        print(f"[INFO] Live viewport: http://127.0.0.1:{port}/  (Ctrl-C stops)")
        if max_requests is None:
            srv.serve_forever()
        else:
            for _ in range(max_requests):
                srv.handle_request()
