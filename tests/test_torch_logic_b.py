"""The second half of the logic corpus through a port Session over a
port SessionCatalog on the CPU (test_torch_logic_a.py says how); a
`cuda`-marked twin runs every file on a card."""

import os

import pytest
import torch

import chip_smoke
from test_torch_logic_a import DATA, HALF
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("path", DATA[HALF:],
                         ids=[os.path.basename(p) for p in DATA[HALF:]])
def test_logic_corpus_second_half(path):
    assert chip_smoke.run_corpus_file(path, "cpu") > 0


@pytest.mark.cuda
@pytest.mark.parametrize("path", DATA,
                         ids=[os.path.basename(p) for p in DATA])
def test_logic_corpus_on_cuda(path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py phase 13 runs the "
                    "corpus there)")
    assert chip_smoke.run_corpus_file(path, "cuda") > 0
