"""Controller layer: core CRD reconcilers, the job-integration framework
(GenericJob SPI), per-job integrations and admission-check controllers.

The port's copy of kueue_tpu/controller: it mirrors the reference's
pkg/controller tree, running on the sim runtime instead of
controller-runtime. Of the job integrations the port has batch/job; the
others wait for ROADMAP item 5b.
"""
