"""The frozen scene generator against the port's, and the placements."""

import numpy as np
import pytest

from bench_port.lib import scenes


@pytest.mark.parametrize("n,seed", [(4000, 0), (9001, 12345)])
def test_room_is_the_port_generators(n, seed):
    from occuseg_tpu_torch.data.synthetic import SceneConfig, generate_scene
    ours = scenes.generate_room(scenes.RoomSpec(n), seed)
    port = generate_scene(SceneConfig(num_points=n, extent=512,
                                      num_objects=24), seed)
    for k in ("xyz", "colors", "labels", "instance_id"):
        np.testing.assert_array_equal(ours[k], port[k])


def test_placement_is_rigid_and_in_the_domain():
    pool = scenes.RoomPool(2 ** 31 + 11, 2, (3000, 4000))
    for p, _ in zip(scenes.placements(pool, 7), range(6)):
        base = pool.rooms[p.room]["xyz"].astype(np.float64)
        for scale in (50.0, 20.0):
            xyz = scenes.place(pool, p, scale)["xyz"].astype(np.float64)
            assert xyz.min() >= 0 and xyz.max() < 4096
            i, j = np.arange(0, 200), np.arange(200, 400)
            d0 = np.linalg.norm(base[i] - base[j], axis=1) * scale / 50
            d1 = np.linalg.norm(xyz[i] - xyz[j], axis=1)
            np.testing.assert_allclose(d1, d0, rtol=1e-4, atol=1e-3)
            np.testing.assert_allclose(xyz[:, 0], base[:, 0] * scale / 50,
                                       rtol=1e-6)


def test_every_seed_gets_the_same_room_sizes():
    sizes = [sorted(r["xyz"].shape[0] for r in
                    scenes.RoomPool(s, 4, (3000, 6000)).rooms)
             for s in (1, 2, 3 * 10 ** 9)]
    assert sizes[0] == sizes[1] == sizes[2]
    a = scenes.RoomPool(5, 2, (3000, 4000)).rooms[0]["xyz"]
    b = scenes.RoomPool(5, 2, (3000, 4000)).rooms[0]["xyz"]
    np.testing.assert_array_equal(a, b)


def test_batch_ground_truth_is_make_batchs():
    from occuseg_tpu_torch.data.synthetic import SceneConfig, make_batch
    seed, n = 4, 5000
    pool = scenes.RoomPool(0, 1, (n, n))
    pool.rooms[0] = scenes.with_centres(
        scenes.generate_room(scenes.RoomSpec(n), seed * 1000))
    ours = scenes.make_batch(pool, [scenes.Placement(0, 0.0, (0.0, 0.0))],
                             50.0, 8192, 16)
    port = make_batch(SceneConfig(num_points=n, extent=512, num_objects=24),
                      1, 8192, 16, seed=seed)
    for k in ("labels", "instance_id", "point_scene"):
        np.testing.assert_array_equal(ours[k], port[k])
    for k in ("offsets", "displacements", "occupancy", "features"):
        np.testing.assert_allclose(ours[k], port[k], rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(ours["coords"][:, 0], port["coords"][:, 0])
