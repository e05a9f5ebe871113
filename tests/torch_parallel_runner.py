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


def _axes_step(conf, ckpt, batch, mesh, dtype, save=None):
    """One train step of a model built on `mesh`, from the one-process
    checkpoint `ckpt` (sliced on load), saved whole to `save`."""
    from m3dssd_tpu_torch.anchors import locate_anchors
    from m3dssd_tpu_torch.models import build
    from m3dssd_tpu_torch.parallel import model_axis
    from m3dssd_tpu_torch.train.state import (create_train_state,
                                              make_train_step)
    from m3dssd_tpu_torch.utils.checkpoint import (restore_checkpoint,
                                                   save_checkpoint,
                                                   whole_state)

    model = build(conf, device="cpu", phase="train", mesh=mesh)
    model.to(dtype)
    state = create_train_state(conf, model, max_iter=100)
    restore_checkpoint(ckpt, state)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    mom = {n: tuple(st["momentum_buffer"].shape)
           for n, st in state.optimizer.state.items()}
    rois = locate_anchors(conf.anchors, conf.feat_size, conf.feat_stride)
    step = make_train_step(conf, rois, mesh=mesh)
    stats = step(state, {k: v.to(dtype) if v.is_floating_point() else v
                         for k, v in _halves(batch, mesh).items()})
    whole = whole_state(state)
    if save and mesh.primary:
        save_checkpoint(save, state, state.step, whole=whole)
    return {"stats": {k: float(v) for k, v in stats.items()},
            "state": whole[0], "shapes": shapes, "mom_shapes": mom,
            "momentum": {n: st["momentum_buffer"]
                         for n, st in whole[1]["state"].items()},
            "sharded": sorted(model_axis.specs_of(model)),
            "spatial": step.on_slabs}


def _axes_detect(d, mesh):
    from m3dssd_tpu_torch.anchors import locate_anchors
    from m3dssd_tpu_torch.inference.detect import make_batch_detector
    from m3dssd_tpu_torch.models import build

    conf = _conf(dict(d["conf"]))
    model = build(conf, device="cpu", seed=3, mesh=mesh)
    rois = locate_anchors(conf.anchors, conf.feat_size, conf.feat_stride)
    det = make_batch_detector(conf, rois, model, device="cpu")
    return det(d["images"], d["sfs"])


def _axes_gradcheck(mesh):
    """gradcheck of the halo exchange, the row gathers and the channel
    gather as functions of a whole tensor every rank holds (the input
    passes copy_to, so its gradient is the sum over ranks)."""
    from m3dssd_tpu_torch.parallel import model_axis
    from m3dssd_tpu_torch.parallel.spatial import (SpatialShard,
                                                   gather_rows, halo,
                                                   local_rows)

    gen = torch.Generator().manual_seed(0)
    out = {}
    if mesh.spatial > 1:
        sp = SpatialShard(mesh.s, mesh.spatial, mesh.spatial_group)
        as_copy = model_axis.ModelShard(mesh.s, mesh.spatial,
                                        mesh.spatial_group)
        x = torch.randn(1, 2, 3 * mesh.spatial, 3, dtype=torch.float64,
                        generator=gen, requires_grad=True)
        for top, bottom in ((1, 1), (2, 0), (0, 3), (4, 2)):
            def f(x, top=top, bottom=bottom):
                xs = local_rows(model_axis.copy_to(x, as_copy), sp)
                return gather_rows(halo(xs, top, bottom, sp), sp)
            out[f"halo{top}{bottom}"] = torch.autograd.gradcheck(f, (x,))

        def g(x):
            xs = local_rows(model_axis.copy_to(x, as_copy), sp)
            y = local_rows(gather_rows(xs, sp, reduce_grad=True), sp)
            return gather_rows(y * y, sp)
        out["gather_rows"] = torch.autograd.gradcheck(g, (x,))
    if mesh.model > 1:
        ms = model_axis.ModelShard(mesh.m, mesh.model, mesh.model_group)
        x = torch.randn(2, 2 * mesh.model, 3, 2, dtype=torch.float64,
                        generator=gen, requires_grad=True)
        w = torch.randn(2 * mesh.model, dtype=torch.float64, generator=gen)

        def h(x):
            xs = model_axis.enter(x, ms, channels=True)
            y = xs * w[ms.part(w.numel())][None, :, None, None]
            return model_axis.gather(y * y, ms)
        out["gather_channels"] = torch.autograd.gradcheck(h, (x,))
    return out


def _ints(shape, seed):
    """A float64 tensor of integers in [-8, 8] (its sums are exact in
    every float type)."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(-8, 9, shape, generator=gen).double()


def _axes_exact(mesh):
    """Whether the collectives move values exactly in float64, float32,
    bf16 and float16: the halo exchange (a halo past the neighbour's slab
    and the image's bottom), the row gather, the channel gather and
    copy_to, forward and backward, on integer-valued tensors."""
    from m3dssd_tpu_torch.parallel import model_axis
    from m3dssd_tpu_torch.parallel.spatial import (SpatialShard,
                                                   gather_rows, halo,
                                                   local_rows)

    out = {}
    for dt in (torch.float64, torch.float32, torch.bfloat16, torch.float16):
        name = str(dt).split(".")[1]
        if mesh.spatial > 1:
            n, i, h, top, bottom = mesh.spatial, mesh.s, 3, 2, 4
            sp = SpatialShard(i, n, mesh.spatial_group)
            x = _ints((1, 2, n * h, 3), 0)
            xs = local_rows(x, sp).to(dt).requires_grad_()
            y = halo(xs, top, bottom, sp)
            padded = torch.nn.functional.pad(x, (0, 0, top, bottom))
            grads = [_ints(y.shape, 10 + j) for j in range(n)]
            y.backward(grads[i].to(dt))
            acc = torch.zeros_like(padded)
            for j in range(n):
                acc[:, :, j * h:(j + 1) * h + top + bottom] += grads[j]
            out[f"halo_{name}"] = (
                torch.equal(y.double(), padded[:, :, i * h:(i + 1) * h
                                               + top + bottom])
                and torch.equal(xs.grad.double(),
                                acc[:, :, top + i * h:top + (i + 1) * h]))
            xs = local_rows(x, sp).to(dt).requires_grad_()
            z = gather_rows(xs, sp)
            g = _ints(z.shape, 20)
            z.backward(g.to(dt))
            out[f"rows_{name}"] = (torch.equal(z.double(), x) and torch.equal(
                xs.grad.double(), local_rows(g, sp)))
        if mesh.model > 1:
            ms = model_axis.ModelShard(mesh.m, mesh.model, mesh.model_group)
            x = _ints((1, 2 * mesh.model, 3, 2), 30)
            xs = x[:, ms.part(x.shape[1])].to(dt).requires_grad_()
            z = model_axis.gather(xs, ms)
            g = _ints(z.shape, 31)
            z.backward(g.to(dt))
            out[f"channels_{name}"] = torch.equal(z.double(), x) and \
                torch.equal(xs.grad.double(), g[:, ms.part(g.shape[1])])
            xc = x.to(dt).requires_grad_()
            model_axis.copy_to(xc, ms).backward(_ints(x.shape, 40 + ms.index)
                                                .to(dt))
            want = sum(_ints(x.shape, 40 + j) for j in range(ms.size))
            out[f"copy_to_{name}"] = torch.equal(xc.grad.double(), want)
    return out


def case_axes(inp, _data_mesh, work):
    """A train step, detect and the collectives' gradchecks on a mesh of
    inp's spatial and model extents (and dla34_depth's DLASeg under a
    spatial axis)."""
    from m3dssd_tpu_torch.parallel import make_mesh, model_axis

    # the model axis shards leaves of 32 channels or more at these widths
    model_axis.MIN_MODEL_DIM = 32
    a = inp["axes"]
    mesh = make_mesh(spatial=a["spatial"], model=a["model"], device="cpu")
    out = {"coords": (mesh.rank, mesh.s, mesh.m),
           "extents": (mesh.size, mesh.spatial, mesh.model)}
    conf = _conf(dict(a["conf"]))
    out["f64"] = _axes_step(conf, a["ckpt64"], a["batch"], mesh,
                            torch.float64, save=os.path.join(work, "saved"))
    out["f32"] = _axes_step(conf, a["ckpt32"], a["batch"], mesh,
                            torch.float32)
    out["detect"] = _axes_detect(a["detect"], mesh)
    out["gradcheck"] = _axes_gradcheck(mesh)
    out["exact"] = _axes_exact(mesh)
    if "depth" in a and mesh.rank == 0:
        out["depth"] = _depth_seg(a["depth"], mesh)
    return out


def depth_seg(seed=0):
    """dla34_depth's DLASeg, seeded (torch's default init; the DCN weights
    uniform), in float64 and train mode."""
    from m3dssd_tpu_torch.models.necks import DCN, DLASeg

    torch.manual_seed(seed)
    seg = DLASeg("dla34_depth")
    for m in seg.modules():
        if isinstance(m, DCN):
            torch.nn.init.uniform_(m.weight, -0.05, 0.05)
            torch.nn.init.uniform_(m.conv_offset_mask.weight, -0.01, 0.01)
    return seg.double().train()


def depth_run(seg, images, reduce_group=None):
    """Output and input gradient of sum(y * ct), and of each parameter's
    gradient its norm and two seeded random projections (the gradients
    themselves are 125 M numbers). `reduce_group`: sum the gradients over
    it first."""
    from m3dssd_tpu_torch.parallel.mesh import all_reduce_grads

    images = images.clone().requires_grad_()
    y, on_slabs = seg.forward_rows(images)
    ct = torch.cos(torch.arange(y.numel(), dtype=y.dtype)).reshape(y.shape)
    params = [images] + list(seg.parameters())
    grads = torch.autograd.grad((y * ct).sum(), params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(params, grads)]
    all_reduce_grads(grads, reduce_group)
    gen = torch.Generator().manual_seed(0)
    summary = {}
    for (n, _), g in zip(seg.named_parameters(), grads[1:]):
        g = g.double().reshape(-1)
        summary[n] = torch.stack([g.norm()] + [
            torch.dot(torch.randn(g.numel(), generator=gen).double(), g)
            for _ in range(2)])
    return {"y": y.detach(), "dimages": grads[0], "params": summary,
            "active": on_slabs}


def _depth_seg(images, mesh):
    """dla34_depth's DLASeg on the spatial ranks of data coordinate 0."""
    from m3dssd_tpu_torch.models.layers import BatchNorm2d
    from m3dssd_tpu_torch.parallel.spatial import SpatialShard

    seg = depth_seg()
    shard = SpatialShard(mesh.s, mesh.spatial, mesh.spatial_group)
    for m in seg.modules():
        if isinstance(m, BatchNorm2d):
            m.process_group = mesh.spatial_group
        if hasattr(m, "spatial_shard"):
            m.spatial_shard = shard
    return depth_run(seg, images, mesh.spatial_group)


CASES = {"core": case_core, "trainer": case_trainer, "axes": case_axes}


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
