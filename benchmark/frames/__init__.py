"""Frame sources of the register cells, found by the ``kind`` in a
configuration's ``frames``: each module's ``make(run, data_root)`` lays the
raw sequences out under ``data_root`` in the layout ``cli register`` reads
and returns the sequence directories, in order."""

import importlib


def make(run, data_root: str) -> list[str]:
    kind = run.cell.config["frames"]["kind"]
    return importlib.import_module(f"benchmark.frames.{kind}").make(run, data_root)
