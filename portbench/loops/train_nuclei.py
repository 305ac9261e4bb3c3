"""Joint nuclei training: the port's ``make_train_step_nuclei`` (the
DPA-P2PNet prompter and SAM 2 trained together) over H&E-like crops, one
step at a time (a closed loop).

The traffic file gives the shape of the work: the ``batch``, the ``pool`` of
distinct tiles with ``cells_min``-``cells_max`` nuclei each, the
augmentation, the loader's worker threads and the ``checked_steps``. The
tiles are made from the seed by :func:`make_tile` (the port's
``synthetic_nuclei`` drawn in its order, tinted like H&E). They reach the
step through the port's own input path, as ``cli/train_2d``'s nuclei loop
runs it: the MoNuSeg reader (augmentation, cell points, cell subset) over
the tiles in memory, its ``DataLoader`` with ``pack_nuclei_batch``, and
``device_prefetch`` to the card. The loader makes one epoch in set-up and
the window feeds it again every epoch: the command line's loader, making
each epoch while the steps run, paces them and spreads the runs.

Set-up builds the model, the prompter, the optimizer and the step once and
drives them through the first ``checked_steps`` steps of the feed, which
warm every shape (the empty bank, then the full one), recording what the
check needs: each step's batch, losses, the prompter's batch statistics, the
mask decoder's logits and the program's choices (the bank's draws, the prompt points, the match); the
first gradient as AdamW holds it after one step; the bank after the first
step and before each later one; the parameters the next step starts from.
The same objects then run the window. After it, the plain reference
(:mod:`portbench.reference.nuclei_plain`) follows those steps from the
seed's initial weights.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
from typing import Dict, List

import numpy as np
import torch

from portbench.counts import nuclei_train as counts
from portbench.lib.weights import make_weights, stream_seed
from portbench.reference.arch import arch
from portbench.reference.nuclei_plain import PlainNucleiTrainer

# H&E stains as RGB in [0, 1]: hematoxylin (nuclei) and eosin (stroma)
HEMATOXYLIN = np.array([0.30, 0.15, 0.50], np.float32)
EOSIN = np.array([0.95, 0.75, 0.85], np.float32)
STREAMS = ("bank", "dropout", "head")
# the controls, the plain reference standing in the program's place: each part
# one step below the precision it runs in (SAM 2 runs bf16, the prompter fp32
# with cuDNN's TF32), or SAM 2 alone below it
CONTROLS = {"lower": {"sam": "fp8", "prompter": "bf16"},
            "sam_fp8": {"sam": "fp8", "prompter": "fp32"}}


def make_tile(rng: np.random.Generator, size: int, num_cells: int):
    """One tile: (RGB image [size, size, 3] in [0, 255], instance map). The
    nuclei, the noise and the trailing point draws are those of the port's
    ``synthetic_nuclei(rng, size, num_cells)``, each candidate ellipse tested
    inside its bounding box; the grey levels are then tinted from eosin
    (background) to hematoxylin (nuclei)."""
    inst = np.zeros((size, size), np.int32)
    pid = 0
    for _ in range(num_cells * 3):
        if pid >= num_cells:
            break
        cy, cx = rng.uniform(10, size - 10, 2)
        ry, rx = rng.uniform(4, 10, 2)
        y0, y1 = max(int(np.floor(cy - ry)), 0), min(int(np.ceil(cy + ry)) + 1, size)
        x0, x1 = max(int(np.floor(cx - rx)), 0), min(int(np.ceil(cx + rx)) + 1, size)
        yy = np.arange(y0, y1)[:, None]
        xx = np.arange(x0, x1)[None, :]
        m = (((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2) <= 1
        sub = inst[y0:y1, x0:x1]
        if (sub[m] != 0).any() or m.sum() < 8:
            continue
        pid += 1
        sub[m] = pid
    grey = np.full((size, size, 3), 0.85, np.float32)
    grey[inst > 0] = 0.35
    grey += rng.normal(0, 0.04, grey.shape)
    for n in np.bincount(inst.ravel(), minlength=pid + 1)[1:]:
        rng.integers(n)
    t = (np.clip(grey, 0, 1) - 0.35) / 0.5
    rgb = HEMATOXYLIN + t * (EOSIN - HEMATOXYLIN)
    return np.clip(rgb * 255.0, 0.0, 255.0).astype(np.float32), inst


def make_pool(seed: int, traffic: dict) -> List[tuple]:
    size = int(traffic["tile_size"])
    out = []
    for i in range(int(traffic["pool"])):
        rng = np.random.default_rng(stream_seed(seed, "tile", i))
        n = int(rng.integers(traffic["cells_min"], traffic["cells_max"] + 1))
        out.append(make_tile(rng, size, n))
    return out


def pool_reader(tiles, image_size: int, out_size: int, seed: int, augment: dict):
    """The port's MoNuSeg training reader over tiles held in memory."""
    from medsam2_tpu_torch.data.augment import NucleiAugmentConfig
    from medsam2_tpu_torch.data.monuseg import MONUSEG

    class PoolReader(MONUSEG):
        def __init__(self):
            self.data_path = None
            self.mode = "train"
            self.image_size = image_size
            self.out_size = out_size
            self.num_mask_per_img = 150
            self.rng = np.random.default_rng(seed)
            self.augment = NucleiAugmentConfig(**augment)
            self.paths = [f"tile{i:04d}.png" for i in range(len(tiles))]

        def _load(self, index):
            img, inst = tiles[index]
            return img, inst, self.paths[index]

    return PoolReader()


def _host(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu().clone() for k, v in batch.items()}


class Loop:
    """One training step of ``batch`` images is one unit of work."""

    def __init__(self, cfg_doc: dict, traffic: dict, seed: int, device):
        self.cfg_doc = cfg_doc
        self.traffic = traffic
        self.seed = int(seed)
        self.device = torch.device(device)
        self.a = arch(cfg_doc["model"])
        self.B = int(traffic["batch"])
        self.checked = int(traffic["checked_steps"])
        self.records: List[dict] = []
        self.model = None

    # -- set-up ------------------------------------------------------------

    def generators(self) -> Dict[str, torch.Generator]:
        """The step's three random streams, seeded from the run's seed."""
        return {s: torch.Generator(device=self.device).manual_seed(stream_seed(self.seed, s))
                for s in STREAMS}

    def setup(self, build_model):
        """``build_model(cfg_doc, device)`` returns (the port's SAM 2, its
        config); the prompter is built here, and the weights of both are
        drawn from the seed in one call and loaded."""
        os.environ.update(self.cfg_doc.get("env", {}))
        from medsam2_tpu_torch.data.loader import DataLoader, device_prefetch
        from medsam2_tpu_torch.data.monuseg import pack_nuclei_batch
        from medsam2_tpu_torch.prompter.criterion import CriterionConfig
        from medsam2_tpu_torch.prompter.dpa_p2pnet import Prompter, PrompterConfig
        from medsam2_tpu_torch.prompter.matcher import MatcherConfig
        from medsam2_tpu_torch.train import recipe_2d, recipe_nuclei as rn

        doc = self.cfg_doc
        model, _ = build_model(doc, self.device)
        with torch.device("meta"):
            prompter = Prompter(PrompterConfig(**doc["prompter"]), device="meta")
        prompter = prompter.to_empty(device=self.device)
        buffers = {n for n, _ in model.named_buffers()}
        buffers |= {"prompter." + n for n, _ in prompter.named_buffers()}
        leaves = [(n, tuple(t.shape), n in buffers) for n, t in model.state_dict().items()]
        leaves += [("prompter." + n, tuple(t.shape), "prompter." + n in buffers)
                   for n, t in prompter.state_dict().items()]
        self.weights = make_weights(leaves, self.seed, self.device, doc.get("weight_overrides"))
        model.load_state_dict({k: v for k, v in self.weights.items()
                               if not k.startswith("prompter.")})
        prompter.load_state_dict({k[len("prompter."):]: v for k, v in self.weights.items()
                                  if k.startswith("prompter.")})
        r = doc["recipe"]
        self.rcfg = rn.NucleiRecipeConfig(
            prompter=prompter.cfg, matcher=MatcherConfig(**r["matcher"]),
            criterion=CriterionConfig(**r["criterion"]),
            **{k: v for k, v in r.items() if k not in ("matcher", "criterion")})
        self.model, self.prompter = model, prompter
        self.opt = rn.make_optimizer_nuclei(model, prompter, self.rcfg)
        self.step = rn.make_train_step_nuclei(model, prompter, self.rcfg, self.opt)
        self.trainables = rn.named_trainables(model, prompter)
        self.bank = recipe_2d.init_bank(model, self.rcfg.memory_bank_size)
        self.bank_written = False
        self.gens = self.generators()

        tr = self.traffic
        S, out, M = self.a.image_size, self.rcfg.out_size, self.rcfg.max_cells
        reader = pool_reader(make_pool(self.seed, tr), S, out, stream_seed(self.seed, "reader"),
                             tr["augment"])
        loader = DataLoader(reader, batch_size=self.B, shuffle=True,
                            seed=stream_seed(self.seed, "loader"),
                            collate_fn=lambda s: pack_nuclei_batch(s, S, out, M),
                            num_workers=int(tr["loader_workers"]))
        # one epoch made in set-up, held in page-locked memory on a card (the
        # prefetch then copies it without staging it again), fed every epoch
        source = list(loader)
        if self.device.type == "cuda":
            source = [{k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                       for k, v in b.items()} for b in source]
        self.epoch = None

        def feed():
            while True:
                self.epoch = device_prefetch(iter(source), self.device)
                yield from self.epoch

        self.feed = feed()

    def _step(self, batch):
        g = self.gens
        self.bank, metrics = self.step(batch, self.bank, self.bank_written, g["bank"],
                                       g["dropout"], g["head"])
        self.bank_written = True
        return metrics

    @contextlib.contextmanager
    def _recording(self, rec: dict):
        """Record what the step chose and made while it runs: the bank's
        draws, the predicted point taken for each cell, the match, the
        prompter's batch statistics, the mask decoder's low-res logits. Each
        recorder calls the program's own function; the logits are read by a
        forward hook on the decoder."""
        from medsam2_tpu_torch.state import similarity_bank as sb
        from medsam2_tpu_torch.train import recipe_nuclei as rn

        orig = {"read": sb.read_similarity_bank, "nearest": rn.find_nearest_points,
                "match": rn.hungarian_match_host, "bn": rn.update_bn_running_stats}

        def read(*a, **k):
            mem, idx = orig["read"](*a, **k)
            rec["bank_idx"] = idx.detach().cpu().clone()
            return mem, idx

        def nearest(pred_coords, gt_points, gt_valid):
            out = orig["nearest"](pred_coords, gt_points, gt_valid)
            d = (pred_coords[:, None, :, :] - out[:, :, None, :]).abs().sum(-1)
            rec["points"] = d.argmin(dim=-1).cpu()
            return out

        def match(*a, **k):
            out = orig["match"](*a, **k)
            rec["match"] = np.array(out)
            return out

        def bn(prompter, stats):
            rec["stats"] = {k: v.detach().cpu().clone() for k, v in stats.items()}
            return orig["bn"](prompter, stats)

        def cells(module, args, out):
            rec["cells"] = out[0][:, 0].detach().float().cpu()

        sb.read_similarity_bank, rn.find_nearest_points = read, nearest
        rn.hungarian_match_host, rn.update_bn_running_stats = match, bn
        hook = self.model.sam_mask_decoder.register_forward_hook(cells)
        try:
            yield rec
        finally:
            hook.remove()
            sb.read_similarity_bank, rn.find_nearest_points = orig["read"], orig["nearest"]
            rn.hungarian_match_host, rn.update_bn_running_stats = orig["match"], orig["bn"]

    def warm(self):
        """The first ``checked_steps`` steps, recorded for the check; they
        run every shape the window uses. Each step keeps its batch, the bank
        it read, its choices, losses and batch statistics, the norm of each
        gradient AdamW applied, and on the host the parameters it ended with
        and AdamW's moments after it (the state the next step starts
        from)."""
        params = [p for _, p in self.trainables]
        self.shapes = [(n, p.shape) for n, p in self.trainables]
        start = None
        for t in range(self.checked):
            batch = next(self.feed)
            rec = {"batch": _host(batch), "start": start,
                   "bank": None if not self.bank_written else self.bank["feats"].clone()}
            with self._recording(rec):
                metrics = self._step(batch)
            self._sync()
            rec["losses"] = {k: float(v) for k, v in metrics.items()}
            rec["grad_norms"] = dict(zip([n for n, _ in self.shapes],
                                         _norms([p.grad for p in params])))
            if t == 0:
                rec["memories"] = self.bank["feats"][: self.B].clone()
            rec["end"] = {"params": _flat_host([p.detach() for p in params]), "t": t + 1}
            if t + 1 < self.checked:
                st = [self.opt.state.get(p, {}) for p in params]
                for k, key in (("m", "exp_avg"), ("v", "exp_avg_sq")):
                    rec["end"][k] = _flat_host([x.get(key, torch.zeros_like(p))
                                                for x, p in zip(st, params)])
            start = rec["end"]
            self.records.append(rec)

    def _tensors(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """A flat host copy of the trained leaves as tensors on the device."""
        return dict(zip([n for n, _ in self.shapes],
                        _unflat(flat, [sh for _, sh in self.shapes], self.device)))

    def program_update(self, t: int) -> Dict[str, torch.Tensor]:
        """Each trained leaf's change in the program's step ``t``."""
        rec = self.records[t]
        end = self._tensors(rec["end"]["params"])
        start = (self._tensors(rec["start"]["params"]) if rec["start"] is not None
                 else {n: self.weights[n] for n in end})
        return {n: end[n] - start[n] for n in end}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- the window ---------------------------------------------------------

    def run_unit(self, keep: bool = True) -> int:
        """One training step, ended by a synchronise; returns the images it
        trained on."""
        self._step(next(self.feed))
        self._sync()
        return self.B

    def layer_modules(self) -> Dict[str, torch.nn.Module]:
        return {"image_encoder": self.model.image_encoder, "prompter": self.prompter}

    def counts(self) -> dict:
        """Work of one step: FLOPs (forward and backward of every trained
        part, the memory encoder's forward) and the forward bytes of each
        hooked layer."""
        return {"flops": counts.step_flops(self.a, self.cfg_doc["prompter"], self.B,
                                           self.rcfg.max_cells),
                "bytes": counts.step_bytes(self.a, self.cfg_doc["prompter"], self.weights,
                                           self.B),
                "work": self.B}

    # -- the check ------------------------------------------------------------

    def release(self):
        """Free the program's model, prompter, optimizer and feed; the
        records stay."""
        self.feed = self.epoch = None
        self.model = self.prompter = self.opt = self.step = self.trainables = None
        self.bank = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def follow(self, precision, follow: List[dict], ties: dict) -> List[dict]:
        """The plain trainer in ``precision`` over the recorded steps, each
        from the state the program's step started from (its parameters and
        AdamW's moments; the seed's initial weights at the first), with the
        program's bank and its draws from it, generators seeded as the
        program's and drawn step after step in its order, and the choices in
        ``follow`` where they tie (none: its own choices). Each step gives
        its record with the gradients and the change of each leaf."""
        trainer = PlainNucleiTrainer(self.weights, self.cfg_doc, precision)
        names = trainer.names
        gens = self.generators()
        steps = []
        for t, rec in enumerate(self.records):
            st = rec["start"]
            if st is not None:
                trainer.load(self._tensors(st["params"]), self._tensors(st["m"]),
                             self._tensors(st["v"]), st["t"])
            start = {n: trainer.leaves[n].detach().clone() for n in names}
            batch = {k: v.to(self.device) for k, v in rec["batch"].items()}
            fol = {} if follow is None else {k: follow[t][k] for k in ("points", "match")}
            out = trainer.step(batch, rec["bank"], rec.get("bank_idx"), gens, fol, ties)
            out["grad_norms"] = dict(zip(names, _norms([out["grads"][n] for n in names])))
            out["update"] = {n: trainer.leaves[n].detach() - start[n] for n in names}
            out["valid"] = batch["gt_valid"]
            del start
            if t > 0:
                out.pop("memories")
            steps.append(out)
        return steps

    def check(self, limits: dict, control: str = None) -> List[dict]:
        """Follow the recorded steps with the plain reference and compare
        (see :func:`compare`). With ``control`` (a key of ``CONTROLS``) the
        reference in that lower precision stands in the program's place,
        from the same states, with its own choices. Returns the compared
        numbers with their limits."""
        ties = {"point_tie": limits["point_tie"], "match_tie": limits["match_tie"]}
        if control is None:
            got = [dict(rec, update=self.program_update(t)) for t, rec in enumerate(self.records)]
        else:
            got = self.follow(CONTROLS[control], None, ties)
        ref = self.follow("fp32", got, ties)
        numbers, diag = compare(got, ref)
        diag["gaps"] = [s["gaps"] for s in ref]
        print("portbench: " + json.dumps({"nuclei_check": diag}), file=sys.stderr)
        return [{"name": k, "value": v, "limit": limits.get(k)} for k, v in numbers.items()]


def _norms(tensors) -> List[float]:
    """The L2 norm of each tensor, in one transfer."""
    return torch.stack([torch.linalg.vector_norm(t.float()) for t in tensors]).tolist()


def _flat_host(tensors) -> torch.Tensor:
    """The tensors as one flat float32 tensor on the host (one transfer)."""
    return torch.cat([t.reshape(-1).float() for t in tensors]).cpu()


def _unflat(flat: torch.Tensor, like, device=None) -> List[torch.Tensor]:
    """Split a flat tensor back into tensors of the shapes of ``like``
    (tensors or shapes), on ``device`` (``like``'s device by default)."""
    out, off = [], 0
    for x in like:
        shape = x.shape if isinstance(x, torch.Tensor) else x
        dev = device if device is not None else x.device
        n = int(np.prod(shape))
        out.append(flat[off: off + n].to(dev).view(shape))
        off += n
    return out


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float().to(b.device), b.float()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b).clamp_min(1e-30))


def _leaf_gap(got: Dict[str, float], ref: Dict[str, float], names) -> Dict[str, float]:
    """|got - ref| / max(ref, the median of ``ref`` over ``names``) per leaf."""
    med = float(np.median([ref[n] for n in names]))
    return {n: abs(got[n] - ref[n]) / max(ref[n], med) for n in names}


def _group(name: str) -> str:
    """A leaf's module: its first name, the prompter's first two."""
    parts = name.split(".")
    return ".".join(parts[:2] if parts[0] == "prompter" else parts[:1])


def _group_gap(got: Dict[str, float], ref: Dict[str, float], names) -> Dict[str, float]:
    """|‖got‖ - ‖ref‖| / ‖ref‖ of each module's gradient, the norms over all
    of its leaves in ``names``."""
    sq_got, sq_ref = {}, {}
    for n in names:
        k = _group(n)
        sq_got[k] = sq_got.get(k, 0.0) + got[n] ** 2
        sq_ref[k] = sq_ref.get(k, 0.0) + ref[n] ** 2
    return {k: abs(sq_got[k] ** 0.5 - sq_ref[k] ** 0.5) / sq_ref[k] ** 0.5 for k in sq_ref}


def _by_part(gaps: Dict[str, float]) -> Dict[str, float]:
    """The largest gap over SAM 2's names and over the prompter's."""
    out = {}
    for n, v in gaps.items():
        side = "prompter" if n.startswith("prompter") else "sam"
        out[side] = max(out.get(side, 0.0), v)
    return out


def _cell_rel(got: torch.Tensor, ref: torch.Tensor, valid: torch.Tensor):
    """The relative L2 of the valid cells' logits over the whole batch, and
    the worst image's: ``got`` and ``ref`` [B * M, h, w], ``valid`` [B, M].
    Rows that ``got`` lacks read as zeros."""
    B, M = valid.shape
    r = ref.float().reshape(B, M, -1)
    a = torch.zeros_like(r).reshape(B * M, -1)
    n = min(got.shape[0], B * M)
    a[:n] = got[:n].float().to(ref.device).reshape(n, -1)
    a = a.reshape(B, M, -1)
    keep = valid.to(ref.device)[..., None]
    num = torch.where(keep, (a - r) ** 2, torch.zeros_like(r)).sum((1, 2))
    den = torch.where(keep, r ** 2, torch.zeros_like(r)).sum((1, 2))
    batch = num.sum().sqrt() / den.sum().sqrt().clamp_min(1e-30)
    return float(batch), float((num.sqrt() / den.sqrt().clamp_min(1e-30)).max())


def compare(got: List[dict], ref: List[dict]):
    """The numbers that decide ``correct``, each the worst over the checked
    steps:

    - ``loss_rel``: over the six losses and their sum, |got - ref| / |ref|;
    - ``grad_group_gap``: over the trained modules (the prompter's by its
      parts), the gap between the norms of the gradients AdamW received,
      |‖g_got‖ - ‖g_ref‖| / ‖g_ref‖, each norm over all of the module's
      leaves;
    - ``update_gap``: over the trained leaves, the gap between the norms of
      each leaf's change in the step, |‖u_got‖ - ‖u_ref‖| / max(‖u_ref‖, the
      median leaf's ‖u_ref‖), over the elements whose reference gradient
      reaches a thousandth of the median leaf's root mean square (AdamW
      moves the others, such as the key biases under softmax, by round-off
      alone);
    - ``bn_rel``: the relative L2 of the prompter mask head's batch mean and
      variance;
    - ``cell_logit_rel``: the relative L2 of the mask decoder's low-res
      logits of the valid cells over the batch: SAM 2's whole forward
      (trunk, memory attention, 1,024-prompt decode). A lower precision
      moves every image; the worst image alone swings from seed to seed;
    - ``bank_rel``: over the memories that the first step wrote to the
      bank, the relative L2 of each.

    Returns (numbers, diagnostics: the same gap of the gradient leaf by leaf,
    against the median leaf's norm, which one small leaf decides; the
    gradient and update gaps over SAM 2's leaves and over the prompter's
    apart; the worst leaf or module of each; the worst image's
    ``cell_logit_rel``; the losses)."""
    loss = grad = grad_group = update = bn = cell = cell_image = 0.0
    worst = {}
    part = {}
    for t, (g, r) in enumerate(zip(got, ref)):
        loss = max([loss] + [abs(g["losses"][k] - r["losses"][k]) / max(abs(r["losses"][k]), 1e-30)
                             for k in r["losses"]])
        gr = r["grad_norms"]
        reached = [n for n in gr if gr[n] > 0]
        gg = _leaf_gap(g["grad_norms"], gr, reached)
        group = _group_gap(g["grad_norms"], gr, reached)
        rms = float(np.median([gr[n] / r["grads"][n].numel() ** 0.5 for n in reached]))
        masks = {n: r["grads"][n].abs() >= 1e-3 * rms for n in reached}
        kept = [n for n in reached if bool(masks[n].any())]
        ug = _leaf_gap(dict(zip(kept, _norms([g["update"][n][masks[n]] for n in kept]))),
                       dict(zip(kept, _norms([r["update"][n][masks[n]] for n in kept]))), kept)
        for key, d in (("grad_leaf", gg), ("grad_group", group), ("update", ug)):
            n = max(d, key=d.get)
            if d[n] > worst.get(key, (None, -1.0))[1]:
                worst[key] = (n, d[n], t)
        grad, grad_group = max(grad, max(gg.values())), max(grad_group, max(group.values()))
        update = max(update, max(ug.values()))
        for key, d in (("grad_group", group), ("update", ug)):
            for side, vals in _by_part(d).items():
                part[f"{side}_{key}_gap"] = max(part.get(f"{side}_{key}_gap", 0.0), vals)
        bn = max([bn] + [_rel(g["stats"][k], r["stats"][k]) for k in ("mean", "var")])
        batch, image = _cell_rel(g["cells"], r["cells"], r["valid"])
        cell, cell_image = max(cell, batch), max(cell_image, image)
    mg, mr = got[0]["memories"], ref[0]["memories"]
    bank = max(_rel(mg[i], mr[i]) for i in range(mr.shape[0]))
    numbers = {"loss_rel": loss, "grad_group_gap": grad_group, "update_gap": update,
               "bn_rel": bn, "bank_rel": bank, "cell_logit_rel": cell}
    diag = {"grad_leaf_gap": grad, **part, "cell_logit_image_gap": cell_image, "worst": worst,
            "losses": [{k: [g["losses"][k], r["losses"][k]] for k in r["losses"]}
                       for g, r in zip(got, ref)]}
    return numbers, diag
