"""Folded volume streaming: the port's ``propagate_volumes_batched`` over
CT-like volumes, one call at a time (a closed loop), a box on slice 0.

The traffic file gives the shape of the work: ``volumes_per_call``,
``slices``, the ``pool`` of distinct volumes that the calls cycle through,
``fold``, the organs per volume. Volumes are made on the card from the seed
(:func:`make_volume`, the port's ``synthetic_volume`` made 3D and smooth):
an ellipse of body, organs as ellipsoids with soft edges that drift across
slices and span tens of them, low-frequency texture and fine noise,
normalised as the port normalises frames. Organ 0, the one the box marks, is
present from slice 0 on. Every seed gives the same sizes.

After the window, a sample of the volumes the calls finished, drawn from the
seed (one from each half of the folded batch; only the sampled rows'
outputs are kept), is propagated again by the plain reference (:mod:`portbench.reference.sam2_plain`) from the volume
regenerated from the seed, and each slice's low-res logits are compared.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from portbench.counts import propagation as counts
from portbench.lib.weights import make_weights, stream_seed
from portbench.reference.arch import arch
from portbench.reference.sam2_plain import PlainSAM2

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def make_volume(seed: int, vid: int, T: int, S: int, organs: int, device):
    """Volume ``vid`` of ``seed``: (frames [T, S, S, 3] normalised float32,
    box corners [2, 2] (x, y) of organ 0 on slice 0)."""
    rng = np.random.default_rng(stream_seed(seed, "volume", vid))
    gen = torch.Generator(device=device).manual_seed(stream_seed(seed, "volume-noise", vid))
    z = torch.arange(T, dtype=torch.float32, device=device)[:, None, None]
    y = torch.arange(S, dtype=torch.float32, device=device)[None, :, None]
    x = torch.arange(S, dtype=torch.float32, device=device)[None, None, :]
    by, bx = rng.uniform(0.34, 0.42, 2) * S
    body = torch.sigmoid((1 - ((y - S / 2) / by) ** 2 - ((x - S / 2) / bx) ** 2) * 12)
    img = 0.06 + 0.36 * body
    box = None
    for o in range(organs):
        ry, rx = rng.uniform(0.07, 0.14, 2) * S
        cy, cx = S / 2 + rng.uniform(-0.16, 0.16, 2) * S
        dy, dx = rng.uniform(-0.004, 0.004, 2) * S
        if o == 0:
            cz = rng.uniform(0.3, 0.45) * T
            rz = rng.uniform(cz / 0.7, 0.95 * T)
        else:
            cz = rng.uniform(0.0, 1.0) * T
            rz = rng.uniform(0.3, 0.6) * T
        inten = rng.uniform(0.55, 0.9)
        d = (((z - cz) / rz) ** 2 + ((y - cy - dy * z) / ry) ** 2
             + ((x - cx - dx * z) / rx) ** 2)
        img = img + (inten - 0.42) * torch.sigmoid((1 - d) * 10)
        if o == 0:
            f = math.sqrt(1 - (cz / rz) ** 2)
            box = torch.tensor([[cx - rx * f, cy - ry * f], [cx + rx * f, cy + ry * f]],
                               dtype=torch.float32, device=device)
    tex = torch.randn(1, 1, T // 4 + 2, S // 32, S // 32, generator=gen, device=device)
    img = img + 0.05 * F.interpolate(tex, size=(T, S, S), mode="trilinear",
                                     align_corners=False)[0, 0]
    img = img + 0.02 * torch.randn(T, S, S, generator=gen, device=device)
    img = img.clamp(0, 1)[..., None]
    mean = torch.tensor(IMAGENET_MEAN, device=device)
    std = torch.tensor(IMAGENET_STD, device=device)
    return (img - mean) / std, box.clamp(0, S - 1)


class Loop:
    """One call of ``propagate_volumes_batched`` is one unit of work."""

    def __init__(self, cfg_doc: dict, traffic: dict, seed: int, device):
        self.cfg_doc = cfg_doc
        self.traffic = traffic
        self.seed = int(seed)
        self.device = torch.device(device)
        self.a = arch(cfg_doc["model"])
        self.V = int(traffic["volumes_per_call"])
        self.T = int(traffic["slices"])
        self.pool = int(traffic["pool"])
        self.fold = bool(traffic["fold"])
        self.organs = int(traffic["organs"])
        self.calls = 0
        half = max(self.V // 2, 1)
        self.halves = [(lo, hi) for lo, hi in ((0, half), (half, self.V)) if hi > lo]
        self.sample_rng = np.random.default_rng(stream_seed(self.seed, "sample"))
        self.kept: Dict[int, tuple] = {}      # half -> (call, row, low-res logits [T, 1, h, w])
        self.model = None

    # -- set-up ------------------------------------------------------------

    def setup(self, build_model):
        """``build_model(cfg_doc, device)`` returns (the port's model, its
        config); the weights are then drawn here from the seed and loaded."""
        from medsam2_tpu_torch.state import memory_bank as mb

        model, port_cfg = build_model(self.cfg_doc, self.device)
        leaves = [(n, tuple(t.shape), n in dict(model.named_buffers()))
                  for n, t in model.state_dict().items()]
        self.weights = make_weights(leaves, self.seed, self.device,
                                    self.cfg_doc.get("weight_overrides"))
        model.load_state_dict(self.weights)
        self.model = model
        self.spec = mb.BankSpec.from_config(port_cfg,
                                            max_cond_frames=self.cfg_doc["max_cond_frames"])
        S = self.a.image_size
        vols, boxes = [], []
        for v in range(self.pool):
            f, b = make_volume(self.seed, v, self.T, S, self.organs, self.device)
            vols.append(f)
            boxes.append(b)
        self.volumes = torch.stack(vols)                 # [pool, T, S, S, 3]
        self.boxes = torch.stack(boxes)                  # [pool, 2, 2]
        self.labels = torch.tensor([2, 3], dtype=torch.int32, device=self.device)

    def _call(self, call: int):
        from medsam2_tpu_torch.api.video_predictor import propagate_volumes_batched

        ids = [(call * self.V + j) % self.pool for j in range(self.V)]
        idx = torch.tensor(ids, device=self.device)
        vids = self.volumes.index_select(0, idx)
        coords = self.boxes.index_select(0, idx)[:, None]            # [V, O=1, 2, 2]
        labels = self.labels.expand(self.V, 1, 2)
        return propagate_volumes_batched(self.model, self.spec, vids, coords, labels,
                                         num_objects=1, prompt_frames=(0,), fold=self.fold)

    def warm(self):
        """One whole call: every shape the window uses."""
        self._call(0)
        self._sync()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- the window ---------------------------------------------------------

    def run_unit(self, keep: bool = True) -> int:
        """One call, ended by a synchronise; returns the slices it finished."""
        out = self._call(self.calls)
        self._sync()
        if keep:
            self._sample(out)
            self.calls += 1
        return self.V * self.T

    def _sample(self, out):
        """Reservoir sampling from the seed: after n calls, each half's kept
        row is a uniform draw among the n calls' rows of that half. Only the
        kept rows' outputs stay on the card."""
        for h, (lo, hi) in enumerate(self.halves):
            take = self.sample_rng.integers(self.calls + 1) == 0
            row = int(self.sample_rng.integers(lo, hi))
            if take:
                self.kept[h] = (self.calls, row, out[row, :, 0].clone())

    def layer_modules(self) -> Dict[str, torch.nn.Module]:
        return {"image_encoder": self.model.image_encoder,
                "memory_attention": self.model.memory_attention}

    def counts(self) -> dict:
        """Work of one unit: FLOPs and bytes by layer, and the slices."""
        return {"flops": counts.call_flops(self.a, self.V, self.T),
                "bytes": counts.call_bytes(self.a, self.weights, self.V, self.T),
                "work": self.V * self.T}

    # -- the check ------------------------------------------------------------

    def release(self):
        """Free the program's model and caches; the kept outputs stay."""
        self.model = None
        self.volumes = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, limits: dict, control: str = None) -> List[dict]:
        """Run the plain reference over the sampled volumes and compare every
        slice given the judged slices before it: ``logit_rel_l2``, the worst
        slice's ||got - want|| / ||want|| over the low-res logits, ``want``
        being the reference's mask, or the candidate the judged mask took
        where the decoder's scores tie within the limits file's
        ``choice_tie`` (see
        :meth:`~portbench.reference.sam2_plain.PlainSAM2.propagate`). With
        ``control`` (``"fp8"``) the reference computed in that precision
        stands in the program's place. Returns the compared numbers with
        their limits."""
        ref = PlainSAM2(self.weights, self.cfg_doc["model"])
        ctl = None if control is None else PlainSAM2(self.weights, self.cfg_doc["model"],
                                                      precision=control)
        errs, gaps = [], []
        for h in sorted(self.kept):
            call, row, kept = self.kept[h]
            vid = (call * self.V + row) % self.pool
            frames, box = make_volume(self.seed, vid, self.T, self.a.image_size, self.organs,
                                      self.device)
            if ctl is None:
                got = kept
            else:
                got = ctl.propagate(frames, box, self.labels)["low"]
            r = ref.propagate(frames, box, self.labels, follow=got, tie=limits["choice_tie"])
            errs.append(r["err"])
            gaps.append(r["gap"])
        self.per_slice = torch.stack(errs).cpu()
        self.per_slice_gap = torch.stack(gaps).cpu()
        return [{"name": "logit_rel_l2", "value": float(self.per_slice.max()),
                 "limit": limits.get("logit_rel_l2")}]
