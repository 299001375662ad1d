"""Traffic: one data file per mix (`<traffic>.json`) and one module per
kind of request (`<kind>.py`), found by name."""
