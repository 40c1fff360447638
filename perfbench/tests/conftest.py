"""Small stand-ins for the cells, for the CPU: the benchmark's own cells at
a width the CPU runs in seconds, seeded weights, short windows."""
import pytest
import torch

from perfbench.harness import Cell

TINY = {
    "qp2_msssim": dict(channel=16, m=2, k=[64, 32, 16], weights={"seeded": True}),
    "a800_gen_16": dict(channel=32, k=64, size=[16, 8, 8, 4, 4, 2, 2, 1, 1], hiddenSize=64, depth=2,
                        nHeads=4, numClasses=10),
}
TRAFFIC = {
    "photos-b10": dict(batch=2, pool=4, sample=1, chunk=2),
    "generate-b8": dict(batch=2, greedy_every=2, sample_greedy=1, sample_drawn=1),
}


def tinyCell(name: str) -> Cell:
    cell = Cell.named(name)
    cell.config = dict(cell.config, **TINY[cell.configName])
    cell.traffic = dict(cell.traffic, **TRAFFIC[cell.trafficName])
    return cell


@pytest.fixture(autouse=True)
def fewThreads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)
