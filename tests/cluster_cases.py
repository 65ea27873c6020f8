"""Scenes and rays shared by the cluster-mode tests on the CPU
(tests/test_torch_cluster.py) and on the card (tests/test_torch_cuda.py);
the port only, so that the card's tests run where JAX is not installed."""

import numpy as np
import torch

from hyper_ray_tracer_tpu_torch import build_scene, prepare_scene
from hyper_ray_tracer_tpu_torch.camera import make_basis
from hyper_ray_tracer_tpu_torch.models.builders import sphereflake
from hyper_ray_tracer_tpu_torch.models.scene import PT_SPHERE
from hyper_ray_tracer_tpu_torch.ops import cluster_sweep as p_cluster_sweep
from hyper_ray_tracer_tpu_torch.ops import rng as prng
from hyper_ray_tracer_tpu_torch.ops.cluster_sweep import cluster_sweep_plain
from hyper_ray_tracer_tpu_torch.render import T_MIN, bounce_step, init_state
from hyper_ray_tracer_tpu_torch.scene_tensors import to_device


def port_scene(name):
    if name == "sphereflake-3":
        return sphereflake(3, "sphereflake-3")
    return build_scene(name)


def upload(scene):
    arrays, layout, mode = prepare_scene(scene, "cluster")
    assert mode == "cluster"
    return to_device(arrays, scene.static, "cpu", layout), layout


def waves(scene, st, W=32, H=18, bounces=3):
    """Camera rays from seed 0 and the compacted waves after them."""
    pix = torch.arange(W * H, dtype=torch.int64)
    state = init_state(make_basis(scene.camera, W, H), W, H, pix.repeat(2),
                       torch.arange(2).repeat_interleave(W * H), 0)
    for b in range(bounces):
        yield state.o, state.d, state.time, state.alive, \
            prng.bounce_base(state.base, b)
        state = bounce_step(st, scene.background, state, b)


def tie_case():
    """(cluster scene, one camera ray, its winning slot a, its t, slot b):
    sphereflake(3) with the last real slot b > a made a copy of a and
    also swept in the tail, so that b is tested before a's cluster and
    gives the same t."""
    scene = port_scene("sphereflake-3")
    st, lay = upload(scene)
    o, d, tm, act, bits = next(waves(scene, st))
    t0, b0 = cluster_sweep_plain(st.cluster, o, d, tm, act, bits, T_MIN)
    i = int(torch.nonzero(b0 >= 0)[0])
    a, b = int(b0[i]), int(np.flatnonzero(lay.src >= 0)[-1])
    assert b > a
    moved = {k: getattr(st.arrays.geom, k).clone()
             for k in ("p0", "p1", "radius")}
    host = st.host_geom._replace(**{k: np.asarray(getattr(
        st.host_geom, k)).copy() for k in moved})
    for k, v in moved.items():
        v[b] = v[a]
        getattr(host, k)[b] = getattr(host, k)[a]
    cs = p_cluster_sweep.cluster_records(
        st.cluster, host, st.arrays.geom._replace(**moved))
    extra = p_cluster_sweep.Group(b, 1, PT_SPHERE, False, False, None)
    cs = cs._replace(tail=cs.tail + (extra,), tail_rows=torch.cat(
        [cs.tail_rows, torch.tensor([[b, 1, 0, 0]], dtype=torch.int32)]))
    ray = tuple(x[i:i + 1].contiguous() for x in (o, d, tm, act, bits))
    return cs, ray, a, float(t0[i]), b


def two_spheres_case(z, boxes):
    """(cluster scene, one ray, the first slots of clusters 0 and 1):
    sphereflake(3)'s run of 4 clusters with one sphere of radius 1 left
    in each of clusters 0 and 1, centred on the z axis at ``z`` (a pair),
    the other slots' spheres moved far off; the boxes of clusters 0 and 1
    set to [-1, 1]^2 x [lo, hi] by ``boxes`` (two (lo, hi) pairs), those
    of clusters 2 and 3 out of the way; the ray from the origin along +z,
    which enters a box at its lo."""
    scene = port_scene("sphereflake-3")
    st, lay = upload(scene)
    run = lay.runs[0]
    first = [run.base + c * run.width for c in (0, 1)]
    moved = {k: getattr(st.arrays.geom, k).clone()
             for k in ("p0", "p1", "radius")}
    real = torch.from_numpy(lay.src >= 0)
    moved["p0"][real] = 1000.0
    moved["p1"][real] = 1000.0
    moved["radius"][real] = 0.5
    for s, zc in zip(first, z):
        moved["p0"][s] = moved["p1"][s] = torch.tensor([0.0, 0.0, zc])
        moved["radius"][s] = 1.0
    host = st.host_geom._replace(**{k: v.numpy() for k, v in moved.items()})
    cs = p_cluster_sweep.cluster_records(
        st.cluster, host, st.arrays.geom._replace(**moved))
    box = cs.boxes.clone()
    for c, (lo, hi) in enumerate(boxes):
        box[c, 0:3] = torch.tensor([-1.0, -1.0, lo])
        box[c, 4:7] = torch.tensor([1.0, 1.0, hi])
    box[2:, 0:3] = 100.0
    box[2:, 4:7] = 101.0
    ray = (torch.zeros(1, 3), torch.tensor([[0.0, 0.0, 1.0]]),
           torch.zeros(1), torch.ones(1, dtype=torch.bool),
           torch.zeros(1, dtype=torch.int64))
    return cs._replace(boxes=box), ray, first


# Equal box entries: (sphere centres, boxes, the winner's cluster, its t).
# Both boxes are entered at 5, beyond both spheres (t 3 and 4; a graze,
# built), so the cluster visited first wins and the other is skipped: on
# equal entries the lower cluster index, cluster 0, whichever sphere is
# nearer; entered first at 4.5, cluster 1.
ENTRY_TIES = [((4.0, 5.0), ((5.0, 6.0), (5.0, 6.0)), 0, 3.0),
              ((5.0, 4.0), ((5.0, 6.0), (5.0, 6.0)), 0, 4.0),
              ((5.0, 4.0), ((5.0, 6.0), (4.5, 6.0)), 1, 3.0)]
