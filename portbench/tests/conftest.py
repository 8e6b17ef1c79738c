"""A tiny size of each cell for the CPU tests: every width the
configuration's own except the BEV grid, the depth of the backbone and
the layers' count, and a few frames a scene."""

import dataclasses
import json

import pytest

from portbench import harness

TINY = dict(backbone_depth=10, bev_h=16, bev_w=16, encoder_layers=2, decoder_layers=2)


def tiny_cell(name: str) -> harness.Cell:
    cell = harness.load_cell(name)
    c = json.loads(json.dumps(cell.config))
    c.update(TINY)
    c["data"]["raw_size"] = [96, 160] if c["version"] == "v1" else [64, 160]
    spec = json.loads(json.dumps(cell.spec))
    if "frames" in spec["check"]:
        spec["check"].update(within=4, frames=2)
    if "window_steps" in spec["check"]:  # the window's first step: a tiny window has one
        spec["check"].update(within=1, window_steps=1)
    tr = dict(cell.traffic, trace_units=1)
    if "scene_frames" in tr:
        tr["scene_frames"] = 3
    if "pool" in tr:
        tr.update(pool=4, scene_break=[3, 2])
    return dataclasses.replace(cell, config=c, spec=spec, traffic=tr)


@pytest.fixture
def tiny():
    return tiny_cell
