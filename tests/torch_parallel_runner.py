"""One rank of a data-parallel case of tests/test_torch_parallel.py.

    python tests/torch_parallel_runner.py CASE RANK WORLD WORKDIR

Joins a gloo group of WORLD CPU processes through the file store
WORKDIR/store (`parallel.init_distributed(init_method="file://...")`),
reads the case's inputs from WORKDIR/inputs.pt (written by the test), runs
the case and writes what it returns to WORKDIR/<CASE>.rank<RANK>.pt. It
imports the port only (no JAX), on one torch thread.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

torch.set_num_threads(1)


def _conf(kw):
    from m3dssd_tpu_torch.config import flagship_conf

    return flagship_conf(kw.pop("crop"), num_scales=2, backbone="dla34",
                         dtype="float32").replace(**kw)


def _halves(batch, mesh):
    from m3dssd_tpu_torch.parallel import shard_batch

    return shard_batch(mesh, batch)


def case_bn(inp, mesh):
    """Train-mode BatchNorm under the group on this rank's half."""
    from m3dssd_tpu_torch.models.layers import batch_norm

    bn = inp["bn"]
    out = {}
    for key, group in (("group", mesh.group), ("local", None)):
        m = batch_norm(bn["weight"].numel()).double().train()
        m.process_group = group
        with torch.no_grad():
            m.weight.copy_(bn["weight"])
            m.bias.copy_(bn["bias"])
            m.running_mean.copy_(bn["running_mean"])
            m.running_var.copy_(bn["running_var"])
        x = _halves({"x": bn["x"]}, mesh)["x"].clone().requires_grad_()
        ct = _halves({"ct": bn["ct"]}, mesh)["ct"]
        y = m(x)
        (y * ct).sum().backward()
        out[key] = {"y": y.detach(), "dx": x.grad, "dw": m.weight.grad,
                    "db": m.bias.grad, "rm": m.running_mean.clone(),
                    "rv": m.running_var.clone()}
    return out


def case_loss(inp, mesh):
    """rpn_3d_loss on this rank's half of each loss case: the loss, its
    gradient with respect to the outputs, and the stats."""
    from m3dssd_tpu_torch.losses.rpn_loss import RPNLossConfig, rpn_3d_loss

    out = {}
    for name, case in inp["loss"].items():
        outputs = {k: v.clone().requires_grad_()
                   for k, v in _halves(case["outputs"], mesh).items()}
        batch = _halves(case["batch"], mesh)
        gen = torch.Generator().manual_seed(5)
        loss, stats = rpn_3d_loss(outputs, batch, *case["consts"],
                                  RPNLossConfig(**case["cfg"]), gen,
                                  group=mesh.group)
        names = ("cls_t", "lse", "bbox_2d", "bbox_3d")
        grads = torch.autograd.grad(loss, [outputs[k] for k in names],
                                    allow_unused=True)
        out[name] = {"loss": loss.detach(), "stats": stats,
                     "grads": dict(zip(names, grads))}
    return out


def _step(conf, sd, batch, mesh, dtype, spy_forms=False):
    from m3dssd_tpu_torch.anchors import locate_anchors
    from m3dssd_tpu_torch.models import build, rpn
    from m3dssd_tpu_torch.train.state import (create_train_state,
                                              make_train_step)

    model = build(conf, device="cpu", phase="train", group=mesh.group)
    model.load_state_dict(sd, strict=True)
    model.to(dtype)
    state = create_train_state(conf, model, max_iter=100)
    rois = locate_anchors(conf.anchors, conf.feat_size, conf.feat_stride)
    step = make_train_step(conf, rois, group=mesh.group)
    forms = []
    real = rpn.confident_topm
    if spy_forms:
        def spy(*a, **k):
            sel = real(*a, **k)
            forms.append("sparse" if bool(sel.ok) else "dense")
            return sel
        rpn.confident_topm = spy
    try:
        stats = step(state, {k: v.to(dtype) if v.is_floating_point() else v
                             for k, v in _halves(batch, mesh).items()})
    finally:
        rpn.confident_topm = real
    return {"stats": {k: float(v) for k, v in stats.items()},
            "state": {k: v.clone() for k, v in model.state_dict().items()},
            "reduced_bytes": step.reduced_bytes, "forms": forms}


def case_step(inp, mesh):
    """One train step on this rank's rows: float32 from the JAX package's
    init, and float64 where the ranks take different align forms."""
    s = inp["step"]
    out = {"f32": _step(_conf(dict(s["conf"])), s["state"], s["batch"],
                        mesh, torch.float32)}
    f = inp["forms"]
    out["forms"] = _step(_conf(dict(f["conf"])), f["state"], f["batch"],
                         mesh, torch.float64, spy_forms=True)
    return out


def case_eval(inp, mesh):
    """test_kitti_3d over the data axis: rank 0's txts, every rank's
    selection metric."""
    from m3dssd_tpu_torch.anchors import locate_anchors
    from m3dssd_tpu_torch.data.synthetic import SyntheticEvalSet
    from m3dssd_tpu_torch.inference.detect import make_batch_detector
    from m3dssd_tpu_torch.inference.test_driver import test_kitti_3d
    from m3dssd_tpu_torch.models import build

    e = inp["eval"]
    conf = _conf(dict(e["conf"]))
    val = SyntheticEvalSet(conf, e["n"], seed=4, **e["im"])
    gt = val.write_labels(os.path.join(e["dir"], "gt")) if mesh.primary \
        else None
    model = build(conf, device="cpu", seed=3)
    rois = locate_anchors(conf.anchors, conf.feat_size, conf.feat_stride)
    det = make_batch_detector(conf, rois, model, device="cpu")
    res_dir = os.path.join(e["dir"], "two_ranks")
    res, sel = test_kitti_3d(val, det, conf, res_dir, gt_path=gt,
                             batch_size=e["bs"], mesh=mesh)
    txts = None
    if mesh.primary:
        txts = {f: open(os.path.join(res_dir, f)).read()
                for f in sorted(os.listdir(res_dir))}
    return {"sel": sel, "res_is_none": res is None, "txts": txts}


def case_mesh(inp, mesh, work):
    """A data axis of one rank in a world of two; the kernel build on
    local rank 0 while the other ranks wait."""
    from m3dssd_tpu_torch.ops import _build
    from m3dssd_tpu_torch.parallel import barrier, make_mesh
    from m3dssd_tpu_torch.parallel.mesh import build_kernels

    sub = make_mesh(1, device="cpu")
    if sub.member:
        barrier(sub)
    done = os.path.join(work, "built")
    seen = []

    def fake_build():
        if mesh.rank == 0:
            time.sleep(0.5)
            open(done, "w").close()
        seen.append(os.path.exists(done))

    real = _build.build
    _build.build = fake_build
    try:
        build_kernels(mesh)
    finally:
        _build.build = real
    return {"sub": (sub.rank, sub.size, sub.member), "built_first": seen}


def case_core(inp, mesh, work):
    return {"bn": case_bn(inp, mesh), "loss": case_loss(inp, mesh),
            "step": case_step(inp, mesh), "eval": case_eval(inp, mesh),
            "mesh": case_mesh(inp, mesh, work)}


def case_trainer(inp, mesh, work):
    """One epoch of the Trainer in the shared run directory."""
    from m3dssd_tpu_torch.data.synthetic import (SyntheticEvalSet,
                                                 SyntheticTrainSet)
    from m3dssd_tpu_torch.train.trainer import Trainer

    t = inp["trainer"]
    conf = _conf(dict(t["conf"]))
    ds = SyntheticTrainSet(conf, t["n"], seed=3, **t["im"])
    val = SyntheticEvalSet(conf, 4, seed=4, **t["im"])
    tr = Trainer(conf, None, t["dir"], device="cpu", dataset=ds,
                 val_dataset=val)
    tr.run(1)
    return {"loss": float(tr.last_stats["loss"]),
            "stats": {k: float(v) for k, v in tr.last_stats.items()},
            "state": tr.model.state_dict(), "step": tr.state.step,
            "best": tr.best_metric, "eval_none": tr.last_eval is None}


CASES = {"core": case_core, "trainer": case_trainer}


def main():
    case, rank, world, work = sys.argv[1], sys.argv[2], sys.argv[3], \
        sys.argv[4]
    os.environ.update(RANK=rank, WORLD_SIZE=world, LOCAL_RANK=rank)
    from m3dssd_tpu_torch.parallel import init_distributed, make_mesh

    init_distributed(device="cpu", init_method="file://" + os.path.join(
        work, f"{case}.store"))
    mesh = make_mesh(device="cpu")
    inp = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)
    out = CASES[case](inp, mesh, work)
    torch.save(out, os.path.join(work, f"{case}.rank{rank}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
