"""Tiny versions of the benchmark's cells, for runs of the harness on the
CPU through the program's plain path."""
import copy

from wavebench import harness

TINY = {"db7_2d.roundtrip": {"shape": [2, 128, 64], "levels": 3},
        "db7_2d.ti_step": {"shape": [2, 64, 64], "levels": 3}}


def tiny_cell(name: str, root: str = harness.ROOT) -> dict:
    cell = copy.deepcopy(harness.load_json(f"{root}/wavebench/workloads/{name}.json"))
    cell.update(TINY[name])
    return cell
