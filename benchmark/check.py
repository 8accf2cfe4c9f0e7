"""The comparison that decides ``correct``: what the timed path produced,
held to the plain reference run on the same raw scenes with the same
weights, once the window has closed and the program's state is freed.

Serving, per distinct frame (every serving of it in the window, each
distinct output once):

  * ``heads``: the widest gap of the cls, reg and dir head outputs of
    the frame's last serving, over the largest magnitude of the
    reference's (each head apart). It covers every layer before the
    heads: kernel 1's canvas, the encoders, the pyramid and kernel 2's
    warp, the shrink and the heads themselves;
  * ``boxes_m``: each served detection's corners against those of the
    reference's box at the same place (the anchor with the nearest
    centre, among all of them, by exact distance), the widest
    coordinate gap in metres;
  * ``scores``: the widest score gap of the same pairs and, where the
    served and the reference's kept sets differ, of each detection that
    one side kept and the other did not against the closest-scored
    detection that decided it on the other side (an overlapping kept
    box, or the last of the ``max_det`` candidates), in the reference's
    own scores. Near-ties of the greedy NMS or of the top-k cut flip on
    rounding and read about that rounding; a detection dropped or added
    reads its whole score.
"""
from __future__ import annotations

import numpy as np
import torch

from . import weights as wlib
from .reference import assemble, decode, labels


HEADS = ("cls_preds", "reg_preds", "dir_preds")


def keep_first_heads(model, heads: dict):
    """A forward hook on ``model`` that copies its first call's head
    outputs into ``heads`` (and returns None: the output stands)."""
    def hook(_module, _inputs, out):
        if not heads:
            heads.update({k: out[k].detach().clone() for k in HEADS})

    return model.register_forward_hook(hook)


def _gap(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.shape != b.shape:
        return float("inf")
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp(min=1e-30))


def detections(dets: dict, dec: dict, kept: np.ndarray, hypes: dict,
               max_det: int = 300) -> dict:
    rc, rs = dec["corners"], dec["scores"]
    out = {"boxes_m": 0.0, "scores": 0.0}
    pc = torch.from_numpy(np.asarray(dets["corners"], np.float32)).to(
        rc.device)
    idx = []
    centers = rc.mean(1)
    for chunk in pc.split(64):
        # exact distances: cdist's matmul form loses centimetres at a
        # hundred metres, and pairs a box with another anchor's there
        d = torch.cdist(chunk.mean(1), centers,
                        compute_mode="donot_use_mm_for_euclid_dist")
        near = d.argmin(1)
        idx.append(near)
        out["boxes_m"] = max(out["boxes_m"], float(
            (chunk - rc[near]).abs().amax()) if len(chunk) else 0.0)
    idx = torch.cat(idx) if idx else torch.zeros(0, dtype=torch.long)
    ps = torch.from_numpy(np.asarray(dets["scores"], np.float32)).to(rc.device)
    if len(ps):
        out["scores"] = float((ps - rs[idx]).abs().max())
    served = set(idx.tolist())
    ref = set(int(i) for i in kept)
    above = torch.where(dec["above"], rs, torch.zeros_like(rs))
    top = torch.topk(above, min(max_det, above.numel())).values
    cut = float(top[-1]) if float(top[-1]) > 0 else hypes["postprocess"][
        "target_args"]["score_threshold"]
    thr = hypes["postprocess"]["nms_thresh"]
    for a in served ^ ref:
        other = sorted(ref if a in served else served)
        gaps = [abs(float(rs[a]) - cut)]
        if other:
            iou = decode.iou_matrix(rc[a:a + 1, :4, :2],
                                    rc[other][:, :4, :2])[0]
            gaps += [abs(float(rs[a]) - float(rs[b]))
                     for b, v in zip(other, iou.tolist()) if v > thr]
        out["scores"] = max(out["scores"], min(gaps))
    return out


def serve(ref, hypes: dict, scenes: list, heads: dict, served: list,
          seed: int, device) -> dict:
    """The serving numbers over every frame the window served."""
    model = ref.build(hypes).to(device).eval()
    model.load_state_dict(wlib.make(wlib.shapes_of(model), seed, device))
    anchors = torch.from_numpy(labels.anchor_grid(hypes).astype(
        np.float32)).to(device)
    numbers = {"heads": 0.0, "boxes_m": 0.0, "scores": 0.0}
    for k, scene in enumerate(scenes):
        outs = [d for j, d in served if j == k]
        if not outs:
            continue
        batch = assemble.to_device(assemble.collate(
            [assemble.assemble(hypes, scene, train=False)]), device)
        with torch.no_grad():
            out = model(batch)
        for key in HEADS:
            numbers["heads"] = max(numbers["heads"],
                                   _gap(heads[k][key], out[key]))
        dec = decode.decode_all(out["cls_preds"][0], out["reg_preds"][0],
                                out["dir_preds"][0], anchors, hypes)
        kept = decode.nms(dec, hypes)
        distinct = {}
        for d in outs:
            distinct[d["corners"].tobytes() + d["scores"].tobytes()] = d
        for d in distinct.values():
            for key, v in detections(d, dec, kept, hypes).items():
                numbers[key] = max(numbers[key], v)
    return numbers


def _leaf_gap(prog: dict, ref: dict, counted) -> float:
    """The worst leaf's gap of norms, |‖p‖ - ‖r‖|, over the larger of
    the reference leaf's norm and the median leaf's."""
    norms = {n: float(ref[n].norm()) for n in counted}
    median = float(np.median(list(norms.values())))
    return max(abs(float(prog[n].norm()) - norms[n]) / max(norms[n], median)
               for n in counted)


def train(ref, hypes: dict, scenes: list, record: dict, traffic: dict,
          seed: int, device) -> dict:
    """The training numbers of the window's first steps:

      * ``heads_first``: the first step's forward (train mode, batch
        statistics), the widest gap of the cls, reg and dir head outputs
        over the largest magnitude of the reference's, each head apart;
      * ``loss_first``: the first step's loss against the reference's,
        relative;
      * ``loss``: each step's loss against the reference's, the widest
        relative gap;
      * ``grad``: the first gradient as Adam holds it after one step
        (its first moment over 1 - beta1), the worst leaf's gap of
        norms;
      * ``change``: each parameter's change over the checked steps, the
        worst leaf's gap of norms.

    Leaves whose reference gradient is under a thousandth of the median
    leaf's are left out of ``grad`` and ``change``: Adam moves them by
    round-off alone."""
    from . import train as mode
    from .reference import loss as rloss

    bs = hypes["train_params"]["batch_size"]
    steps = traffic["checked_steps"]
    np.random.seed(mode.numpy_seed(seed))
    batches = [assemble.to_device(assemble.collate(
        [assemble.assemble(hypes, s, train=True)
         for s in scenes[i * bs:(i + 1) * bs]]), device)
        for i in range(traffic["batches"])]
    model = ref.build(hypes).to(device)
    model.load_state_dict(wlib.make(wlib.shapes_of(model), seed, device))
    opt = rloss.adam(model, hypes)
    beta1 = opt.param_groups[0]["betas"][0]
    first = {n: p.detach().clone() for n, p in model.named_parameters()}
    losses, grad, heads = [], None, {}
    hook = keep_first_heads(model, heads)
    for k in range(steps):
        losses.append(float(rloss.step(model, opt, batches[k % len(batches)],
                                       hypes)))
        if k == 0:
            grad = {n: opt.state[p]["exp_avg"] / (1 - beta1)
                    for n, p in model.named_parameters()}
    hook.remove()
    change = {n: p.detach() - first[n] for n, p in model.named_parameters()}
    norms = {n: float(g.norm()) for n, g in grad.items()}
    median = float(np.median(list(norms.values())))
    counted = [n for n, v in norms.items() if v >= 1e-3 * median]
    gaps = [abs(p - r) / abs(r) for p, r in zip(record["losses"], losses)]
    return {
        "heads_first": max(_gap(record["heads"][k], heads[k])
                           for k in HEADS),
        "loss_first": gaps[0],
        "loss": max(gaps),
        "grad": _leaf_gap(record["grad"], grad, counted),
        "change": _leaf_gap(record["change"], change, counted),
        "leaves_left_out": len(norms) - len(counted),
    }


def train_flops(ref, hypes: dict, scenes: list, seed: int, device) -> int:
    """FLOPs of the reference's forward, loss and backward on one batch."""
    from .reference import loss as rloss
    from .work import flops

    np.random.seed(0)
    batch = assemble.to_device(assemble.collate(
        [assemble.assemble(hypes, s, train=True) for s in scenes]), device)
    model = ref.build(hypes).to(device).train()
    model.load_state_dict(wlib.make(wlib.shapes_of(model), seed, device))

    def fwd_bwd():
        rloss.total_loss(model(batch), batch,
                         hypes["loss"]["args"]).backward()

    return flops.count(fwd_bwd)
