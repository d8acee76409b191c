"""The generator ``room_spheres``: sphere batches cut from seeded rooms
(rooms.py, spheres.py).

Keys of its mixes:
  training         augmentation and jittered centres (the training
                   sampler), or the test sampler without either
  rooms, points_per_room, room_size_m, boxes_per_room, frames_per_room,
  room_seed        the rooms and the spheres cut from them (the same in
                   every run)
  pool_batches     batches made in set-up and cycled through in order
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict

import numpy as np

from portbench.traffic.generator import Pool, seeds
from portbench.traffic.rooms import make_room, render_views
from portbench.traffic.spheres import SpherePool, prepare_room


def make_pool(model: Dict, mix: Dict, seed: int) -> Pool:
    # The rooms and the spheres cut from them are the mix's own, the same in
    # every run, so that every run of a cell does as much work; the run's
    # seed draws their order, their grouping into batches, the augmentation
    # and (elsewhere) the weights.
    room_seeds = seeds(mix["room_seed"], mix["rooms"] + 1)

    def room(s):
        r = make_room(s, mix["points_per_room"], tuple(mix["room_size_m"]), mix["boxes_per_room"])
        if model["fusion"] != "none":
            r.update(render_views(r, mix["frames_per_room"], model["image_height"], model["image_width"], seed=s))
        return prepare_room(r, model, np.random.RandomState(s))

    # one thread a room (numpy releases the interpreter lock); each room's
    # draws come from its own seed, so the order of completion changes nothing
    with ThreadPoolExecutor(max_workers=min(4, mix["rooms"])) as ex:
        rooms = list(ex.map(room, room_seeds[:-1]))
    run_rng = np.random.RandomState(seeds(seed, 1)[0])
    sampler = SpherePool(rooms, model, mix["training"], np.random.RandomState(room_seeds[-1]), run_rng)
    b = model["batch_num"]
    spheres = [sampler.sphere() for _ in range(mix["pool_batches"] * b)]
    order = run_rng.permutation(len(spheres))
    batches = [{k: np.stack([spheres[j][k] for j in order[i:i + b]]) for k in spheres[0]}
               for i in range(0, len(order), b)]
    return Pool(batches, [int(x["mask"].sum()) for x in batches])
