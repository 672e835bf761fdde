"""Two-image reconstruction web demo (stdlib HTTP, rendering on the device).

Counterpart of `splatt3r_slam_tpu/runtime/webdemo.py` (the reference's
Gradio app: upload one or two images → two-view Gaussian prediction →
`gaussians.ply` in a browser splat viewer). A stdlib `http.server` app
whose 3D view is rendered remotely: the browser sends orbit angles, the
device rasterizes the predicted gaussians through the tile renderer (the
hand-written CUDA compositor on the card), and a JPEG comes back. Drag to
orbit, scroll to dolly, download the .ply.

Endpoints:
  GET  /                 HTML page (upload + viewer)
  POST /reconstruct      JSON {"images": [data URL or base64, ...]} (1 or 2)
                         → {"ok": true, "n_gaussians": N}
  GET  /render?yaw=&pitch=&radius=   JPEG (quality 90) of the current scene
  GET  /gaussians.ply    3DGS-format PLY of the current scene

Uploads (PNG or JPEG) are decoded, and `/render` encoded, by the port's
own codecs (`utils/image.py`, `utils/jpeg.py`), without any image package;
the JPEG is the one the JAX app's `cv2.imencode` writes.
"""

from __future__ import annotations

import base64
import io
import json
import threading
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

_PAGE = """<!DOCTYPE html>
<html><head><title>Splatt3R demo</title><style>
body{font-family:sans-serif;max-width:720px;margin:2em auto;color:#222}
#view{border:1px solid #999;cursor:grab;touch-action:none}
button{padding:.4em 1.2em}#status{color:#666;margin-left:1em}
</style></head><body>
<h2>Splatt3R — two-image 3D Gaussian reconstruction</h2>
<p>Upload one or two images, then Run. Drag the viewer to orbit,
scroll to dolly. Rendering happens on the accelerator; the browser
only displays images.</p>
<input type="file" id="files" accept="image/*" multiple>
<button id="run">Run</button><span id="status"></span>
<p><a href="/gaussians.ply" download>Download gaussians.ply</a></p>
<canvas id="view" width="512" height="384"></canvas>
<script>
let yaw=0, pitch=0.2, radius=0, busy=false, dirty=false;
const cv=document.getElementById('view'), ctx=cv.getContext('2d');
const status=document.getElementById('status');
async function draw(){
  if(busy){dirty=true;return} busy=true;
  const q=`yaw=${yaw}&pitch=${pitch}&radius=${radius}`;
  const img=new Image();
  img.onload=()=>{ctx.drawImage(img,0,0);busy=false;
                  if(dirty){dirty=false;draw()}};
  img.onerror=()=>{busy=false};
  img.src=`/render?${q}&t=${Date.now()}`;
}
let drag=null;
cv.addEventListener('pointerdown',e=>{drag=[e.clientX,e.clientY];
  cv.setPointerCapture(e.pointerId)});
cv.addEventListener('pointermove',e=>{if(!drag)return;
  yaw+=(e.clientX-drag[0])*0.01; pitch+=(e.clientY-drag[1])*0.005;
  pitch=Math.max(-1.2,Math.min(1.2,pitch));
  drag=[e.clientX,e.clientY]; draw()});
cv.addEventListener('pointerup',()=>drag=null);
cv.addEventListener('wheel',e=>{e.preventDefault();
  radius+=e.deltaY*0.002; draw()},{passive:false});
document.getElementById('run').onclick=async()=>{
  const fs=document.getElementById('files').files;
  if(fs.length<1||fs.length>2){status.textContent=
    'pick one or two images';return}
  status.textContent='reconstructing…';
  const images=await Promise.all([...fs].map(f=>new Promise(r=>{
    const rd=new FileReader();rd.onload=()=>r(rd.result);
    rd.readAsDataURL(f)})));
  const resp=await fetch('/reconstruct',{method:'POST',
    headers:{'Content-Type':'application/json'},
    body:JSON.stringify({images})});
  const out=await resp.json();
  status.textContent=out.ok?`${out.n_gaussians} gaussians`:out.error;
  if(out.ok){yaw=0;pitch=0.2;radius=0;draw()}
};
draw();
</script></body></html>
"""

@dataclass
class Scene:
    """The current reconstruction: render inputs on the device, and the
    raw per-gaussian arrays the 3DGS PLY wants."""

    means: torch.Tensor  # (n, 3)
    cov_triu: torch.Tensor  # (n, 6)
    colors: torch.Tensor  # (n, 3)
    opacities: torch.Tensor  # (n,)
    ply_arrays: dict = field(default_factory=dict)  # numpy, for export
    hw: tuple = (384, 512)
    center: np.ndarray = None
    radius: float = 1.0


def scene_gaussians(res1, res2, im1, im2):
    """Both views' predictions → (means, cov_triu, colors, opa, ply
    arrays): colours from the SH residual over each source image. The ply
    arrays' "sh" holds that colour (the web app's PLY), "sh_residual" the
    model's raw residual (the demo CLI's PLY, as the reference demo's)."""
    from splatt3r_slam_tpu_torch.splat.gaussians import (
        RGB2SH,
        SH2RGB,
        build_covariance,
        cov_to_triu,
    )

    means, covs, cols, opas = [], [], [], []
    ply = {k: [] for k in ("means", "scales", "rotations", "sh",
                           "sh_residual", "opacities")}
    for res, im in ((res1, im1), (res2, im2)):
        m = res["means"][0].reshape(-1, 3).float()
        scales = res["scales"][0].reshape(-1, 3).float()
        rots = res["rotations"][0].reshape(-1, 4).float()
        sh0 = res["sh"][0][..., 0].reshape(-1, 3).float() + RGB2SH(
            torch.clamp(im[0] * 0.5 + 0.5, 0, 1).reshape(-1, 3))
        opa = res["opacities"][0].reshape(-1).float()
        means.append(m)
        covs.append(cov_to_triu(build_covariance(scales, rots)))
        cols.append(torch.clamp(SH2RGB(sh0), 0, 1))
        opas.append(opa)
        for k, v in (("means", m), ("scales", scales), ("rotations", rots),
                     ("sh", sh0.reshape(-1, 3, 1)),
                     ("sh_residual", res["sh"][0].reshape(-1, 3, 1).float()),
                     ("opacities", opa)):
            ply[k].append(v.cpu().numpy())
    return (torch.cat(means), torch.cat(covs), torch.cat(cols),
            torch.cat(opas), {k: np.concatenate(v) for k, v in ply.items()})


def orbit_view(center, radius, yaw, pitch, hw, device):
    """(world→camera view (4, 4), K (3, 3)) of the orbit camera, 60° vfov,
    on `device`."""
    from splatt3r_slam_tpu_torch.runtime.visualization import (
        orbit_pose,
        vfov_to_intrinsics,
    )

    h, w = hw
    T = orbit_pose(center, radius, float(yaw), float(pitch))
    view = torch.as_tensor(np.linalg.inv(T).astype(np.float32),
                           device=device)
    return view, torch.as_tensor(vfov_to_intrinsics(60.0, h, w),
                                 device=device)


class DemoEngine:
    """Owns the model and the current scene; thread-safe.

    model: a `Splatt3RModel` on `device`, run under inference_mode."""

    def __init__(self, model, img_size=512, k_max=256, device="cuda"):
        from splatt3r_slam_tpu_torch import resolve_device

        self.model = model
        self.img_size = int(img_size)
        self.k_max = int(k_max)
        self.device = resolve_device(device)
        self.scene: Scene | None = None
        self.lock = threading.Lock()

    # -- reconstruction ------------------------------------------------
    def reconstruct_arrays(self, imgs_np):
        """imgs_np: list of 1 or 2 HxWx3 float [0, 1] arrays."""
        from splatt3r_slam_tpu_torch.utils.draw import resize_area
        from splatt3r_slam_tpu_torch.utils.image import resize_img

        if len(imgs_np) == 1:  # the reference duplicates a single upload
            imgs_np = [imgs_np[0], imgs_np[0]]
        imgs_np = [np.asarray(im, np.float32) for im in imgs_np[:2]]
        # the two views share one resolution: a second image of another
        # size is resampled onto the first's grid before the crop
        if imgs_np[1].shape != imgs_np[0].shape:
            h0, w0 = imgs_np[0].shape[:2]
            imgs_np[1] = resize_area(imgs_np[1], (w0, h0))
        ims = [torch.as_tensor(resize_img(im, self.img_size)["img"],
                               device=self.device) for im in imgs_np]
        with torch.inference_mode():
            res1, res2 = self.model(ims[0], ims[1])
            means, cov, cols, opa, ply = scene_gaussians(res1, res2, *ims)
        m_np = ply["means"]
        scene = Scene(
            means=means, cov_triu=cov, colors=cols, opacities=opa,
            ply_arrays=ply, hw=tuple(int(v) for v in ims[0].shape[1:3]),
            center=m_np.mean(axis=0),
            radius=0.5 * float(np.linalg.norm(m_np.std(axis=0))) + 1.0)
        with self.lock:
            self.scene = scene
        return scene

    # -- rendering -----------------------------------------------------
    def render(self, yaw=0.0, pitch=0.2, dolly=0.0):
        """Rasterize the current scene from an orbit pose → HxWx3 uint8,
        or None before the first reconstruction."""
        from splatt3r_slam_tpu_torch.splat.decoder import _rasterizer

        with self.lock:
            scene = self.scene
        if scene is None:
            return None
        view, K = orbit_view(scene.center, max(scene.radius + dolly, 0.05),
                             yaw, pitch, scene.hw, self.device)
        with torch.inference_mode():
            img = _rasterizer("auto", scene.means)(
                scene.means, scene.cov_triu, scene.colors, scene.opacities,
                view, K, scene.hw, k_max=self.k_max)
        return (np.clip(img.cpu().numpy(), 0, 1) * 255).astype(np.uint8)

    def ply_bytes(self):
        from splatt3r_slam_tpu_torch.parallel.export import save_as_ply

        with self.lock:
            scene = self.scene
        if scene is None:
            return None
        buf = io.BytesIO()
        a = scene.ply_arrays
        save_as_ply(buf, a["means"], a["scales"], a["rotations"], a["sh"],
                    a["opacities"])
        return buf.getvalue()


def _decode_image(data_url_or_b64: str) -> np.ndarray:
    """data:image/...;base64,xxxx or bare base64 of a PNG or JPEG → HxWx3
    float [0, 1]."""
    from splatt3r_slam_tpu_torch.utils.image import decode_image

    raw = base64.b64decode(data_url_or_b64.split(",", 1)[-1])
    return decode_image(raw, "upload").astype(np.float32) / 255.0


def make_handler(engine: DemoEngine):
    from splatt3r_slam_tpu_torch.utils.jpeg import encode_jpeg

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, body, ctype="application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            url = urlparse(self.path)
            if url.path == "/":
                self._send(200, _PAGE.encode(), "text/html")
            elif url.path == "/render":
                q = parse_qs(url.query)

                def f(k, d):
                    try:
                        return float(q.get(k, [d])[0])
                    except ValueError:
                        return d
                img = engine.render(f("yaw", 0.0), f("pitch", 0.2),
                                    f("radius", 0.0))
                if img is None:
                    self._send(404, b'{"error": "no scene yet"}')
                    return
                self._send(200, encode_jpeg(img, 90), "image/jpeg")
            elif url.path == "/gaussians.ply":
                ply = engine.ply_bytes()
                if ply is None:
                    self._send(404, b'{"error": "no scene yet"}')
                else:
                    self._send(200, ply, "application/octet-stream")
            else:
                self._send(404, b'{"error": "not found"}')

        def do_POST(self):
            if urlparse(self.path).path != "/reconstruct":
                self._send(404, b'{"error": "not found"}')
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n))
                imgs = [_decode_image(s) for s in req["images"]]
                if not 1 <= len(imgs) <= 2:
                    raise ValueError("provide one or two images")
                scene = engine.reconstruct_arrays(imgs)
                body = json.dumps({
                    "ok": True,
                    "n_gaussians": int(scene.ply_arrays["means"].shape[0]),
                }).encode()
                self._send(200, body)
            except Exception as e:  # surface to the browser
                self._send(400, json.dumps(
                    {"ok": False, "error": str(e)}).encode())

    return Handler


def serve(engine: DemoEngine, host="127.0.0.1", port=7860):
    """The bound server (not yet serving): call `serve_forever()`, in a
    thread if need be, and `shutdown()` to stop it."""
    return ThreadingHTTPServer((host, port), make_handler(engine))
