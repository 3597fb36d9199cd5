"""Core model layer: resource arithmetic, workload Info, cohort
hierarchy, priority resolution (reference: pkg/resources, pkg/workload,
pkg/hierarchy, pkg/util/priority)."""
