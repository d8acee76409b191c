"""ScanNet 20-class task metadata: a copy of ``mvkpconv_tpu/data/meta.py``
(``tests/test_torch_data.py`` pins it).

Mirrors mvpnet/data/meta_files/labelids.txt (the 20 ScanNet benchmark
classes) and the color palette in mvpnet/utils/visualize.py:50. The raw→
nyu40→20-class mapping itself lives in the preprocessing module; models only
ever see labels in [0, 20) or ignore (−1 internally; the reference uses −100
on the mvpnet side and label remapping on the KPConv side).
"""

CLASS_NAMES = (
    "wall", "floor", "cabinet", "bed", "chair", "sofa", "table", "door",
    "window", "bookshelf", "picture", "counter", "desk", "curtain",
    "refrigerator", "shower curtain", "toilet", "sink", "bathtub",
    "otherfurniture",
)

NUM_CLASSES = len(CLASS_NAMES)

# nyu40 ids of the 20 evaluated classes (labelids.txt order)
NYU40_EVAL_IDS = (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33, 34, 36, 39)

SCANNET_COLOR_PALETTE = (
    (174, 199, 232), (152, 223, 138), (31, 119, 180), (255, 187, 120),
    (188, 189, 34), (140, 86, 75), (255, 152, 150), (214, 39, 40),
    (197, 176, 213), (148, 103, 189), (196, 156, 148), (23, 190, 207),
    (247, 182, 210), (219, 219, 141), (255, 127, 14), (158, 218, 229),
    (44, 160, 44), (112, 128, 144), (227, 119, 194), (82, 84, 163),
)
