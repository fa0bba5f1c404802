#!/bin/sh
# Run the test suite on the host CPU with an 8-device virtual mesh
# (SURVEY §4).  tests/conftest.py pins JAX to the CPU.
cd "$(dirname "$0")/.." || exit 1
JAX_PLATFORMS=cpu python3 -m pytest tests/ -x -q "$@"
