"""Per-framework job integrations (reference: pkg/controller/jobs/*).

Importing a submodule registers its integration; `register_all()` loads
every integration the port has (the reference's side-effect imports in
cmd/kueue/main.go). The port has batch/job (`job`); the JAX package's
jobset, kubeflow, ray, pod and deployment integrations wait for ROADMAP
item 5b, so their framework names do not resolve and
`setup_integrations` raises ValueError("unknown integration ...") for
them. Unlike the JAX package's, `register_all` names only the modules
that exist and swallows no ImportError.
"""

import importlib

_MODULES = ["job"]


def register_all():
    for mod in _MODULES:
        importlib.import_module(f"kueue_tpu_torch.controller.jobs.{mod}")
