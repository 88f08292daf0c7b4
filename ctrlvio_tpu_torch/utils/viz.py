"""Offline trajectory visualization (the rviz replacement; the port's own
copy of `ctrlvio_tpu/utils/viz.py`).

The reference publishes live rviz topics — spline path, control points,
landmarks, relocalized keyframes (`odometry_viewer.h:89-224`). This
environment is headless, so the equivalent artifacts are files:

- `write_html_replay`: ONE self-contained HTML file (no network, no deps)
  with an interactive 3D canvas replay — estimated path, ground truth,
  spline control points, landmark cloud, camera marker, play/scrub bar,
  drag-to-orbit. Open in any browser.
- `write_png`: a matplotlib 4-panel summary (top view, side view, altitude
  and speed vs time) for quick terminal-adjacent inspection.

CLI: `python -m ctrlvio_tpu_torch viz traj.tum [--gt gt.tum] [--ckpt ck.npz]
[--points pts.npz] [-o traj.html] [--png traj.png]`.
"""

from __future__ import annotations

import json

import numpy as np


def load_tum(path: str):
    """Read a TUM trajectory file -> (t_sec (N,), p (N,3), q_wxyz (N,4))."""
    rows = np.loadtxt(path, comments="#", ndmin=2)
    t = rows[:, 0]
    p = rows[:, 1:4]
    q = rows[:, [7, 4, 5, 6]]  # file order qx qy qz qw -> wxyz
    return t, p, q


_HTML = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>ctrlvio_tpu replay</title>
<style>
 body { margin:0; background:#111; color:#ddd; font:13px sans-serif; }
 #bar { padding:6px 10px; display:flex; gap:10px; align-items:center; }
 #cv { display:block; width:100vw; height:calc(100vh - 40px); }
 input[type=range] { flex:1; }
 .sw { display:inline-block; width:10px; height:10px; margin-right:4px; }
</style></head><body>
<div id="bar">
 <button id="play">&#9654;</button>
 <input type="range" id="t" min="0" max="{nmax}" value="0">
 <span id="lbl"></span>
 <span><i class="sw" style="background:#4da3ff"></i>estimate</span>
 <span><i class="sw" style="background:#888"></i>ground truth</span>
 <span><i class="sw" style="background:#ffb347"></i>control pts</span>
 <span><i class="sw" style="background:#3f6"></i>landmarks</span>
 <span style="opacity:.6">drag: orbit &nbsp; wheel: zoom</span>
</div>
<canvas id="cv"></canvas>
<script>
const D = {data};
const cv = document.getElementById('cv'), ctx = cv.getContext('2d');
let yaw = 0.7, pitch = 0.5, zoom = 1.0, k = 0, playing = false;
const all = [].concat(D.est, D.gt || [], D.knots || [], D.points || []);
const ctr = [0,1,2].map(i => all.reduce((s,p)=>s+p[i],0)/all.length);
const rad = Math.max(...all.map(p => Math.hypot(p[0]-ctr[0],p[1]-ctr[1],p[2]-ctr[2]))) || 1;
function proj(p) {
  const x = p[0]-ctr[0], y = p[1]-ctr[1], z = p[2]-ctr[2];
  const cy=Math.cos(yaw), sy=Math.sin(yaw), cp=Math.cos(pitch), sp=Math.sin(pitch);
  const x1 = cy*x + sy*y, y1 = -sy*x + cy*y;
  const y2 = cp*y1 - sp*z, z2 = sp*y1 + cp*z;
  const s = Math.min(cv.width, cv.height) * 0.45 * zoom / rad;
  return [cv.width/2 + x1*s, cv.height/2 - z2*s, y2];
}
function poly(pts, style, w, upto) {
  ctx.strokeStyle = style; ctx.lineWidth = w; ctx.beginPath();
  const n = upto === undefined ? pts.length : upto;
  for (let i = 0; i < n; i++) {
    const q = proj(pts[i]);
    i ? ctx.lineTo(q[0], q[1]) : ctx.moveTo(q[0], q[1]);
  }
  ctx.stroke();
}
function dots(pts, style, r) {
  ctx.fillStyle = style;
  for (const p of pts) {
    const q = proj(p);
    ctx.fillRect(q[0]-r, q[1]-r, 2*r, 2*r);
  }
}
function draw() {
  cv.width = cv.clientWidth; cv.height = cv.clientHeight;
  ctx.fillStyle = '#111'; ctx.fillRect(0,0,cv.width,cv.height);
  if (D.points) dots(D.points, '#3f63', 1.5);
  if (D.knots) dots(D.knots, '#ffb347', 2.5);
  if (D.gt) poly(D.gt, '#888', 1);
  poly(D.est, '#4da3ff', 2, k+1);
  const c = proj(D.est[k]);
  ctx.fillStyle = '#fff'; ctx.beginPath();
  ctx.arc(c[0], c[1], 5, 0, 7); ctx.fill();
  document.getElementById('lbl').textContent =
    't=' + D.t[k].toFixed(2) + 's  ' + (k+1) + '/' + D.est.length;
}
const slider = document.getElementById('t');
slider.oninput = () => { k = +slider.value; draw(); };
document.getElementById('play').onclick = () => { playing = !playing; };
setInterval(() => { if (playing) { k = (k+1) % D.est.length;
  slider.value = k; draw(); } }, 50);
let drag = null;
cv.onmousedown = e => drag = [e.clientX, e.clientY];
window.onmouseup = () => drag = null;
window.onmousemove = e => { if (drag) {
  yaw += (e.clientX-drag[0])*0.008; pitch += (e.clientY-drag[1])*0.008;
  drag = [e.clientX, e.clientY]; draw(); } };
cv.onwheel = e => { zoom *= e.deltaY < 0 ? 1.1 : 0.9; draw();
  e.preventDefault(); };
window.onresize = draw;
draw();
</script></body></html>
"""


def write_html_replay(out_path: str, t, p_est, p_gt=None, knots=None,
                      points=None, max_points: int = 4000):
    """Self-contained interactive HTML replay (≙ the rviz path/marker
    topics of `odometry_viewer.h:89-224`, offline)."""
    def clean(a):
        return None if a is None else np.asarray(a, float).round(4).tolist()

    pts = None
    if points is not None and len(points):
        points = np.asarray(points, float)
        if len(points) > max_points:
            points = points[:: len(points) // max_points + 1]
        pts = clean(points)
    data = {"t": np.asarray(t, float).round(3).tolist(),
            "est": clean(p_est), "gt": clean(p_gt),
            "knots": clean(knots), "points": pts}
    html = _HTML.replace("{data}", json.dumps(data)) \
        .replace("{nmax}", str(len(data["est"]) - 1))
    with open(out_path, "w") as f:
        f.write(html)
    return out_path


def write_png(out_path: str, t, p_est, p_gt=None, knots=None, points=None):
    """4-panel matplotlib summary: top/side views, altitude, speed."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    p = np.asarray(p_est)
    fig, ax = plt.subplots(2, 2, figsize=(11, 8))
    for a, (i, j), name in ((ax[0, 0], (0, 1), "top (x-y)"),
                            (ax[0, 1], (0, 2), "side (x-z)")):
        if points is not None and len(points):
            a.plot(points[:, i], points[:, j], ".", ms=1, color="#3f6",
                   alpha=0.25, label="landmarks")
        if knots is not None:
            a.plot(knots[:, i], knots[:, j], "s", ms=2, color="#ffb347",
                   label="control pts")
        if p_gt is not None:
            a.plot(p_gt[:, i], p_gt[:, j], "-", color="#888", label="gt")
        a.plot(p[:, i], p[:, j], "-", color="#1f77b4", lw=1.5, label="est")
        a.set_title(name)
        a.axis("equal")
        a.legend(fontsize=7)
    ax[1, 0].plot(t, p[:, 2], color="#1f77b4")
    if p_gt is not None:
        ax[1, 0].plot(t, p_gt[:, 2], color="#888")
    ax[1, 0].set_title("altitude z(t)")
    dt = np.diff(np.asarray(t))
    dt[dt <= 0] = np.nan
    spd = np.linalg.norm(np.diff(p, axis=0), axis=1) / dt
    ax[1, 1].plot(np.asarray(t)[1:], spd, color="#1f77b4")
    ax[1, 1].set_title("speed [m/s]")
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path
