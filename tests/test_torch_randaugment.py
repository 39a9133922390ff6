"""RandomAugment on the port (rs_ov_torch.data.randaugment) against rs_ov's:
every op alone and the BLIP train recipe give the same bytes for a seed."""

import numpy as np
import pytest

from rs_ov.data.randaugment import RandomAugment as JaxRandomAugment
from rs_ov.data.randaugment import _level_args
from rs_ov_torch.data.randaugment import RandomAugment

OPS = sorted(_level_args(0))
RECIPE = ["Identity", "AutoContrast", "Brightness", "Sharpness", "Equalize", "ShearX", "ShearY",
          "TranslateX", "TranslateY", "Rotate"]


def _image(seed):
    return np.random.RandomState(seed).randint(0, 256, size=(37, 53, 3)).astype(np.uint8)


@pytest.mark.parametrize("op", OPS)
def test_each_op_gives_the_same_bytes(op):
    for seed in range(4):
        ours = RandomAugment(2, 7, isPIL=True, augs=[op], seed=seed)
        theirs = JaxRandomAugment(2, 7, isPIL=True, augs=[op], seed=seed)
        img = _image(seed)
        a, b = ours(img), theirs(img)
        assert a.dtype == np.uint8 and a.shape == img.shape
        assert np.array_equal(a, b), (op, seed)


def test_the_blip_recipe_gives_the_same_bytes():
    ours = RandomAugment(2, 5, isPIL=True, augs=RECIPE, seed=3)
    theirs = JaxRandomAugment(2, 5, isPIL=True, augs=RECIPE, seed=3)
    for seed in range(8):
        img = _image(10 + seed)
        assert np.array_equal(ours(img), theirs(img))
