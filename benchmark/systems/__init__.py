"""The program under test, one module per kind of cell (the configuration's
`system`): how the benchmark builds the port's model, operator, loss and
chain state as the port's CLI builds them, and which of the port's drivers
runs the chains."""
import importlib


def load(kind: str):
    return importlib.import_module(f"systems.{kind}")
