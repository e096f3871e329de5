import os

from .config import Config, compose  # noqa: F401
from .registry import instantiate  # noqa: F401

# the port's copy of the conf tree (byte-identical to afft_tpu/conf)
CONF_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "conf")


def read_expt_file(path):
    """Override lines of an ``expts/*.txt`` file (comments dropped)."""
    res = []
    with open(path) as fin:
        for line in fin:
            args = line.split("#")[0].strip()
            if args:
                res.append(args)
    return res


def expt_lines_without(path, prefixes):
    """``read_expt_file(path)`` without the lines that start with one of
    ``prefixes``: the keys that another choice of module does not take
    (MATT takes none of a block fuser's ``model.fuser.*``, the CA-Fuser
    no ``model.fuser.depth``)."""
    prefixes = tuple(prefixes)
    return [ln for ln in read_expt_file(path) if not ln.startswith(prefixes)]
