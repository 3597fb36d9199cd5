"""Primitive utilities (reference: pkg/util/*)."""
