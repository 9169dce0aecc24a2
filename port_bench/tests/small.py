"""Cells at a size a test run can hold: 2^log_rows rows and the tests'
own pool over the cell's, and a table of 25 columns (three absorbs a
row) in place of the configuration's 16,384, whose 1,639 absorbs a row
the plain twins and the reference would take minutes to hash on a CPU."""

import harness

COLUMNS = {"table_commit": 25}


def small_cell(spec: dict, workload: str, log_rows: int,
               pool: int = 2) -> "harness.Cell":
    config = dict(harness.Cell(spec, workload).config, log_rows=log_rows)
    columns = COLUMNS.get(config["operation"])
    if columns is not None:
        config["columns"] = columns
    return harness.Cell(spec, workload, config=config, mix={"pool": pool})
