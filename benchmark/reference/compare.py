"""The comparisons that decide `correct`.

Each number compares what the timed path produced with what the
reference works out from the same inputs:
- `trunk`: the encoder's tokens of the frame and the decoder's three
  deeper hooks of both views, from the two images (the keyframe's tokens
  stamped with its frame id in token 0, feature 0, as the oracle stamps
  them): the largest relative L2 error, ‖program − reference‖ /
  ‖reference‖, over the tensors and the checked frames;
- `heads`: the tracking heads (points, confidences, descriptors and their
  confidences) of both views, on the program's own hooks; `gauss`: the
  gaussian head on the same hooks. Both in the activations' own
  coordinates, where a product's rounding error is an absolute error: the
  points as dir·log1p(|p|) (their raw value, since |p| = expm1(raw)),
  confidences as log(c), scales as log(s), the rest as they are. On the
  activated values `exp` multiplies each raw error by the value itself, so
  with random weights the few largest values of a frame set the number and
  it swings from seed to seed by an order of magnitude. Heads that the
  configuration states in bfloat16 are judged as a multiple of the error
  of the same heads computed plainly in bfloat16 (`Network` at "bf16"):
  the bare error of either depends on the seed's weights threefold, the
  multiple does not;
- `match`: the share of the matcher's rows whose match differs, on the
  program's own head outputs and its start;
- `render`: the relative L2 error of the rendered frame, from the
  program's gaussian predictions of the frame, the cross ones coloured by
  the image of the keyframe the program rendered with (the newest after
  the frame: the frame itself where it became one);
- `accum`: the gaussians the map accumulated from a checked keyframe
  (`render.to_world` from the program's predictions of it and its pose
  at the time), the largest relative L2 error over means, covariances,
  colours and opacities;
- `track`: the tracked pose of a checked frame against the reference
  step's (`solve.track`) from the same keyframe state and start
  (`geometry.pose_gap`); `fusion`: the keyframe pointmap that step fused,
  from the program's pose; `solve`: the keyframes' poses after a checked
  backend solve against the reference solve's (`solve.pose_graph`) from
  the same poses and pointmaps;
- `drift`: the largest gap of any processed frame's pose from the true
  one. The matches are the nearest pixel, so sound runs read some 1-2% of
  the scene's depth; a solve that diverges, on both sides alike, reads
  tens of percent;
- `keyframes`: frames whose keyframe decision differs from the
  criterion's on the true poses (a decision within `margin` of the
  threshold is not judged: there the program's float32 pixel positions
  and these float64 ones may round to different pixels); `edges`: the
  backend's edges that differ from the expected ones. Both are exact.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import geometry, matching, render, solve

HEAD_KEYS = ("pts3d", "conf", "desc", "desc_conf")
GAUSS_KEYS = ("offset_raw", "scales", "rotations", "sh", "opacities")


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    """‖a − b‖ / ‖b‖ in float64 (1.0 where either holds a non-finite
    value the other does not)."""
    a, b = a.double(), b.double()
    fa, fb = torch.isfinite(a), torch.isfinite(b)
    if not bool((fa == fb).all()) or not bool(
            (a[~fa] == b[~fb]).all()):
        return 1.0
    a, b = a[fa], b[fb]
    den = float(torch.linalg.vector_norm(b))
    num = float(torch.linalg.vector_norm(a - b))
    return num / den if den > 0 else (0.0 if num == 0 else 1.0)


def raw(key: str, t: torch.Tensor) -> torch.Tensor:
    """An activated head output in its raw coordinates."""
    t = t.double()
    if key == "pts3d":
        n = torch.linalg.vector_norm(t, dim=-1, keepdim=True)
        return t * torch.log1p(n) / torch.clamp(n, min=1e-300)
    if key in ("conf", "desc_conf", "scales"):
        return torch.log(t)
    return t


def heads_error(ref: dict, cand: dict, keys, floor: dict | None = None
                ) -> float:
    """The largest relative L2 error over the outputs `keys`, each in raw
    coordinates; with `floor` (the same heads computed plainly in the
    precision the configuration states), each as a multiple of the
    floor's own error."""
    out = []
    for k in keys:
        if k not in ref or k not in cand:
            continue
        e = rel_l2(raw(k, cand[k]), raw(k, ref[k]))
        if floor is not None:
            f = rel_l2(raw(k, floor[k]), raw(k, ref[k]))
            e = e / f if f > 0 else (0.0 if e == 0 else math.inf)
        out.append(e)
    return max(out)


def stamp(feat: torch.Tensor, fid: int) -> torch.Tensor:
    out = feat.clone()
    out[0, 0, 0] = float(fid)
    return out


class Judge:
    """Numbers for one run, from the reference network `net` (float32)
    and the run's inputs: the configuration's SLAM section, the frames,
    the scene and the true poses."""

    def __init__(self, net, slam: dict, frames, scene, poses, hw,
                 retrieval: bool, heads_precision: str = "fp32",
                 gaussians: dict | None = None):
        self.net, self.slam, self.frames = net, slam, frames
        self.gaussians = gaussians or {}
        # heads the configuration states below float32 are judged against
        # the same heads computed plainly in that precision
        self.floor = (None if heads_precision == "fp32" else
                      net.with_precision("fp32", heads_precision))
        self.scene, self.poses, self.hw = scene, poses, hw
        self.stride = int(slam["matching"].get("match_stride", 1))
        self.expect = geometry.Expectation(scene, poses, slam, retrieval)

    # -- the network, the matcher, the render: on the checked frames --------
    @torch.no_grad()
    def trunk(self, cap, cand_net=None) -> float:
        """The reference chain from the images against the program's
        outputs, or (with `cand_net`) against that network's chain."""
        img_f = self.frames[cap["j"]: cap["j"] + 1]
        img_k = self.frames[cap["kf"]: cap["kf"] + 1]
        out = []
        chains = [self.net] + ([cand_net] if cand_net is not None else [])
        res = []
        for net in chains:
            f, pos = net.encode(img_f)
            k, kpos = net.encode(img_k)
            d1, d2 = net.decode(f, pos, stamp(k, cap["kf"]), kpos)
            res.append((f, d1, d2))
        (rf, r1, r2) = res[0]
        if cand_net is None:
            cf = cap["encode"][0]
            _, _, (c1, c2) = cap["decode"]
        else:
            cf, c1, c2 = res[1]
        out.append(rel_l2(cf, rf))
        for a, b in zip(c1[1:] + c2[1:], r1[1:] + r2[1:]):
            out.append(rel_l2(a, b))
        return max(out)

    @torch.no_grad()
    def heads(self, cap, cand_net=None) -> tuple[float, float | None]:
        """(tracking heads, gaussian head) on the program's hooks: with a
        floor (heads stated below float32), each output's error as a
        multiple of the floor's."""
        out = {"tracking": [], "gaussian_only": []}
        for num in (1, 2):
            for mode, keys in (("tracking", HEAD_KEYS),
                               ("gaussian_only", GAUSS_KEYS)):
                if ("head", num, mode) not in cap:
                    continue
                hooks, prog = cap[("head", num, mode)]
                ref = self.net.head(num, hooks, self.hw, mode)
                cand = (prog if cand_net is None else
                        cand_net.head(num, hooks, self.hw, mode))
                floor = (None if self.floor is None else
                         self.floor.head(num, hooks, self.hw, mode))
                out[mode].append(heads_error(ref, cand, keys, floor))
        gau = out["gaussian_only"]
        return max(out["tracking"]), (max(gau) if gau else None)

    def _sub(self, a):
        s = self.stride
        return a[:, ::s, ::s] if s > 1 else a

    @torch.no_grad()
    def match(self, cap, dtype=None) -> float:
        """Share of rows whose match differs: the program's (or, with
        `dtype`, the matcher in that arithmetic) against the reference's
        on the program's head outputs."""
        idx_init, prog_idx = cap["step"]["idx_init"], cap["step"]["idx"]
        (_, r1), (_, r2) = cap[("head", 1, "tracking")], \
            cap[("head", 2, "tracking")]
        args = (self._sub(r1["pts3d"]), self._sub(r2["pts3d"]),
                self._sub(r1["desc"]), self._sub(r2["desc"]), idx_init,
                self.slam["matching"])
        ref, _ = matching.match(*args)
        cand = prog_idx if dtype is None else matching.match(
            *args, dtype=dtype)[0]
        return float((cand.reshape(-1) != ref.reshape(-1)).float().mean())

    @torch.no_grad()
    def render(self, cap, dtype=None) -> float | None:
        if cap.get("image") is None:
            return None
        pred, cross = cap["pred"]
        img_f = self.frames[cap["j"]: cap["j"] + 1]
        img_k = self.frames[cap["ref"]: cap["ref"] + 1]
        T = cap["T_WC"]
        ref = render.render_frame(pred, cross, img_f, img_k, T, self.hw)
        cand = cap["image"] if dtype is None else render.render_frame(
            pred, cross, img_f, img_k, T, self.hw, dtype=dtype)
        return rel_l2(cand, ref)

    @torch.no_grad()
    def accum(self, chunk, dtype=None) -> float:
        """The map's gaussians of a checked keyframe: the program's (or,
        with `dtype`, the reference's in that arithmetic) against the
        reference's in float64, the largest relative L2 error over means,
        covariances, colours and opacities."""
        gcfg = self.gaussians
        img = self.frames[chunk["fid"]: chunk["fid"] + 1]
        preds = [chunk["pred"]] + ([chunk["cross"]] if gcfg.get(
            "include_cross") and chunk["cross"] is not None else [])

        def world(dt):
            outs = [render.to_world(
                p, img, chunk["T_WC"], gcfg["spatial_stride"],
                gcfg["depth_min"], gcfg["depth_max_percentile"],
                gcfg["max_scale"], gcfg["min_confidence"], dt)
                for p in preds]
            return [torch.cat([o[k] for o in outs]) for k in range(4)]

        ref = world(torch.float64)
        cand = chunk["out"] if dtype is None else world(dtype)
        return max(rel_l2(a, b) for a, b in zip(cand, ref))

    # -- the solves: on the checked frames and solves ----------------------
    def _state(self, T8):
        return T8.detach().to(torch.float64)

    def track(self, cap, ar=solve.REFERENCE) -> tuple[float, float, float]:
        """(pose, fusion, drift) of a checked frame's tracking step: the
        gap between the program's pose and the reference step's from the
        same keyframe state and start, the relative L2 error of the fused
        keyframe pointmap (from the program's pose), and the gap between
        the program's pose and the true one. With `ar` the control's
        arithmetic stands in the program's place."""
        st = cap["step"]
        j, k = cap["j"], cap["kf"]
        sc, s, t = self.scene, self.stride, self.slam["tracking"]
        dev = st["T"].device
        idx, ok = sc.matches(self.poses[k], self.poses[j], s)
        Xf = torch.from_numpy(sc.sub(sc.points(self.poses[j]), s)[idx]).to(
            dev)
        Xkf = torch.from_numpy(sc.in_camera(self.poses[k],
                                            self.poses[j])).to(dev)
        kf = st["kf"]
        n = float(kf.N_fused)
        Xk = self._state(kf.X).reshape(sc.h, sc.w, 3)[::s, ::s].reshape(-1, 3)
        Ck = self._state(kf.C).reshape(sc.h, sc.w, 1)[::s, ::s].reshape(-1, 1)
        conf = 10.0  # the oracle's confidences
        valid = (torch.from_numpy(ok).to(dev)[:, None]
                 & (Ck / n > float(t["C_conf"]))
                 & bool(conf > float(t["C_conf"]))
                 & bool(conf > float(t["Q_conf"])))
        Q = torch.full_like(Ck, conf)
        T_init, T_WCk = self._state(st["T_init"]), self._state(kf.T_WC)

        def run(arith):
            T, _, failed = solve.track(Xf, Xk, T_init, T_WCk, Q, valid, t,
                                       arith)
            frac = float(valid.double().mean())
            return T_init if failed or frac < float(t["min_match_frac"]) \
                else T.to(torch.float64)

        ref = run(solve.REFERENCE)
        cand = self._state(st["T"]) if ar is solve.REFERENCE else run(ar)
        cand = cand.cpu().numpy()
        gap = geometry.pose_gap(cand, geometry.sim3_matrix(ref.cpu().numpy()),
                                sc.d)
        drift = geometry.pose_gap(cand, self.poses[j], sc.d)
        # the fusion, from the program's own pose
        T_CkCf = solve.compose(solve.inverse(T_WCk), self._state(st["T"]))
        reloc = bool(st["flags"][3] > 0.5)
        X = self._state(kf.X)
        C = self._state(kf.C)
        Ckf = torch.full_like(C, conf)
        want = X if reloc else solve.fuse(X, C, Xkf, Ckf, T_CkCf)
        got = (self._state(st["kf_new"].X) if ar is solve.REFERENCE else
               X if reloc else solve.fuse(X, C, Xkf, Ckf, T_CkCf, ar))
        return gap, rel_l2(got, want), drift

    def backend(self, snap, ar=solve.REFERENCE) -> float | None:
        """The largest pose gap over the keyframes of a checked backend
        solve: the program's solved poses against the reference solve's
        from the same keyframe poses and pointmaps, with the matches of
        every edge worked out from the true poses."""
        gaps = []
        lcfg = self.slam["local_opt"]
        pix = max(1, int(lcfg.get("gn_stride", 1)) // (self.stride ** 2))
        for args, _, out in snap["calls"]:
            Twc, Xs, Cs, ii, jj = args[:5]
            dev = Xs.device
            fids = snap["fids"]
            idx, valid = [], []
            for a, b in zip(ii.tolist(), jj.tolist()):
                i, ok = self.scene.matches(self.poses[fids[b]],
                                           self.poses[fids[a]], self.stride)
                idx.append(i)
                valid.append(ok)
            idx = torch.from_numpy(np.stack(idx)).to(dev)
            valid = torch.from_numpy(np.stack(valid)).to(dev)
            Q = torch.full(idx.shape, 10.0, dtype=torch.float64, device=dev)
            T0 = self._state(Twc)

            def run(arith):
                return solve.pose_graph(T0, Xs, Cs, ii, jj, idx, valid, Q,
                                        lcfg, pix, arith).to(torch.float64)

            ref = run(solve.REFERENCE).cpu().numpy()
            cand = (self._state(out) if ar is solve.REFERENCE
                    else run(ar)).cpu().numpy()
            pin = int(lcfg["pin"])
            for r in range(pin, ref.shape[0]):
                gaps.append(geometry.pose_gap(
                    cand[r], geometry.sim3_matrix(ref[r]), self.scene.d))
        return max(gaps) if gaps else None

    # -- the closed loop: every frame and every edge --------------------------
    def loop(self, sessions, margin: float) -> dict:
        """{keyframes, edges, drift} over the run's sessions [(records,
        summary)]: `drift` is the largest gap of a processed frame's pose
        (after its keyframe event, if it became one) from the true one."""
        kf_bad = edge_bad = 0
        drift = 0.0
        for records, summary in sessions:
            for r in records:
                drift = max(drift, geometry.pose_gap(
                    r["T_WC"], self.poses[r["j"]], self.scene.d))
                if r["mode"] == "TRACKING":
                    want, dist = self.expect.keyframe(r["j"], r["kf"])
                    got = r["flag"] and r["after"] == "TRACKING"
                    if r["after"] != "TRACKING" or (
                            got != want and dist > margin):
                        kf_bad += 1
            want = self.expect.edges(summary["keyframes"])
            got = [tuple(e) for e in summary["edges"]]
            edge_bad += sum(a != b for a, b in zip(got, want)) + abs(
                len(got) - len(want))
        return {"keyframes": float(kf_bad), "edges": float(edge_bad),
                "drift": drift}
