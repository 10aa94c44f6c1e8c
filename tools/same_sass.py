"""Whether this checkout's CUDA kernels compile to the same machine code as
another checkout's.

Builds each named library of ``kvcache_factory_tpu_torch/ops/kernels/
_build.py`` (its ``csrc/<source>.cu`` with the port's nvcc flags and, for a
library of ``_build.VARIANTS``, that variant's ``-D`` flags) from this
repository and from another checkout (a directory holding
``kvcache_factory_tpu_torch/csrc``, for example the parent commit unpacked
by ``git archive``) with the same source name and flags, every build side
by side, disassembles the libraries with ``cuobjdump -sass`` and compares
every function's instructions.  Prints one line a library and exits 1 if
any function differs or exists in one build only.  Needs nvcc and
cuobjdump (the machine with the card):

    python3 tools/same_sass.py build/old flash_prefill decode_attn decode_attn_quant_wide
"""

import re
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from kvcache_factory_tpu_torch.ops.kernels import _build  # noqa: E402


def sass_functions(source: Path, defines, lib: Path) -> dict:
    """{function name: its SASS lines} of ``source`` built as a library."""
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, *defines, "-o", str(lib),
                    str(source)], check=True, capture_output=True, text=True)
    tool = str(Path(_build.nvcc_path()).with_name("cuobjdump"))
    text = subprocess.run([tool, "-sass", str(lib)], check=True, capture_output=True,
                          text=True).stdout
    # Names inside an anonymous namespace carry a hash of the source file,
    # and a mangled name its parameter types: pair the two builds' functions
    # by name and template arguments alone (``..._d<D>`` entry points keep
    # their names).
    text = re.sub(r"_GLOBAL__N__\w+?_cu_[0-9a-f]{8}", "_GLOBAL__N_", text)
    funcs, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = re.sub(r"(I(?:Li\d+E)+E)Ev.*", r"\1", m.group(1))
            funcs[name] = []
        elif name and line.strip().startswith("/*"):
            funcs[name].append(line.strip())
    return funcs


def main(argv):
    other, names = Path(argv[0]).resolve(), argv[1:]
    same_all = True
    with tempfile.TemporaryDirectory() as tmp:
        jobs = []
        for name in names:
            source, defines = _build._source(name)
            for side, root in (("this", REPO), ("other", other)):
                jobs.append((root / "kvcache_factory_tpu_torch" / "csrc" / source.name, defines,
                             Path(tmp) / f"{side}_{name}.so"))
        with ThreadPoolExecutor(len(jobs)) as pool:
            built = list(pool.map(lambda job: sass_functions(*job), jobs))
        for i, name in enumerate(names):
            mine, theirs = built[2 * i], built[2 * i + 1]
            differ = sorted(f for f in set(mine) | set(theirs) if mine.get(f) != theirs.get(f))
            same_all &= not differ
            print(f"{name}: {len(mine)} / {len(theirs)} functions, "
                  f"{sum(map(len, mine.values()))} / {sum(map(len, theirs.values()))} SASS "
                  f"lines; identical: {not differ}" + (f"; differ: {differ[:6]}" if differ else ""))
    return 0 if same_all else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
