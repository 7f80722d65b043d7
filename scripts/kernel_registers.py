"""The registers ptxas gives each padded kernel instance, for checkouts of
the port compared in one call (the padded entry points' fd float32
instances must keep theirs while the others are added).

    python3 scripts/kernel_registers.py ROOT [ROOT ...]

Each ROOT is a checkout (``.`` for this one; an unpacked ``git archive``
of another commit).  Needs ``nvcc`` (a machine with the card): it builds
each checkout's kernels, as ``pdwt_tpu_torch/kernels/_build.py`` does on a
first launch, and prints one line per ``*_padded_kernel`` instance and per
instance with a ``PAD`` template argument: ROOT, the demangled-ish name,
ptxas's register line.
"""
import re
import subprocess
import sys

ENTRY = re.compile(r"Compiling entry function '(\S+)'")
# the anonymous namespace's prefix of a mangled name, up to the kernel's own
PREFIX = re.compile(r"_ZN\d+_GLOBAL__N__\w+?_cu_\w+?\d+(?=[a-z])")

for root in sys.argv[1:]:
    log = subprocess.run([sys.executable, "-c", "from pdwt_tpu_torch.kernels import _build; "
                          "_build.load(); print(_build.build_log())"], cwd=root,
                         capture_output=True, text=True, check=True).stdout.splitlines()
    name = None
    for line in log:
        m = ENTRY.search(line)
        if m:
            name = m.group(1)
            continue
        if name and "registers" in line and ("padded" in name or "Lb1E" in name):
            print(root, PREFIX.sub("", name)[:70], line.split(":", 1)[1].strip())
            name = None
