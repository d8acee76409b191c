"""Tiny sizes for the CPU tests: the cells' configurations and mixes with
small budgets, three levels, two views of 24×32 and small rooms."""

TINY_MODEL = dict(
    architecture=["simple", "resnetb", "resnetb_strided", "resnetb", "resnetb_strided", "resnetb",
                  "nearest_upsample", "unary", "nearest_upsample", "unary"],
    first_subsampling_dl=0.08, in_radius=0.7, num_points=[512, 128, 32], conv_neighbors=[12, 12, 12],
    pool_neighbors=[12, 12], first_features_dim=16, num_views=2, image_height=24, image_width=32, batch_num=2,
)
TINY_MIX = dict(rooms=2, points_per_room=20000, room_size_m=[3.0, 3.0, 2.5], boxes_per_room=2,
                frames_per_room=4, pool_batches=4)


def tiny_cell(name: str):
    from portbench import harness

    cell = harness.Cell.from_benchmark(name)
    cell.conf["model"].update(TINY_MODEL)
    cell.mix.update(TINY_MIX)
    return cell
