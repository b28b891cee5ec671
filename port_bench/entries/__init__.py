"""The entries a traffic mix drives, one module each, found by the
traffic file's "entry" name: `entries/<entry>.py` defines `Entry`.

An Entry is built from (configuration, traffic, seed, device) and has:
`unit` (what the window counts), `setup(parts)`, `window(seconds)` (the
timed stretch: "units", "seconds", "failed", and what the end-to-end
readers take), `profile()` (the traced stretches, `drive.profile`),
`finish()` (whatever the check needs of the program after the window),
`flops_per_unit()`, `release()` (frees the program), and
`readings(control=False)`: the numbers the check compares, of the
program against the reference at the configuration's precision, or of
the control in the program's place.
"""

from __future__ import annotations

import importlib


def entry_class(name: str):
    """`Entry` of entries/<name>.py."""
    return importlib.import_module(f"port_bench.entries.{name}").Entry
