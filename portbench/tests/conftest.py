"""Shared set-up of the benchmark's CPU tests: a cell of BENCHMARK.json cut
to a size the CPU runs in seconds (DLA-34 at 64x128, float32, two images a
call), and the `cuda` marker of tests that need the card."""

import copy

import pytest
import torch

from portbench import spec

torch.set_num_threads(1)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card")


def tiny(cell, backbone="dla34", size=(64, 128)):
    """`cell` at the CPU test size (a copy)."""
    cell = copy.deepcopy(cell)
    H, W = size
    cell.config["model"].update(backbone=backbone, test_scale=[H, W],
                                crop_size=[H, W], compute_dtype="float32")
    cell.config["program"]["replace"].update(
        back_bone=backbone, crop_size=[H, W], test_scale=[H, W],
        compute_dtype="float32")
    cell.traffic.update(height=H, width=W, batch=2, pool=2, trace_calls=2,
                        warmup_rounds=1)
    return cell


@pytest.fixture(scope="session")
def bench():
    return spec.load_bench()


@pytest.fixture(scope="session")
def cells(bench):
    return {w["name"]: spec.Cell(bench, w["name"])
            for w in bench["workloads"]}


@pytest.fixture(scope="session")
def tiny_cells(cells):
    return {name: tiny(cell) for name, cell in cells.items()}
