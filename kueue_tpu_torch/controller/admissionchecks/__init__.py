"""AdmissionCheck controllers (reference: pkg/controller/admissionchecks):
provisioning (cluster-autoscaler ProvisioningRequest gate) and multikueue
(multi-cluster dispatch, whose capacity columns feed the solver's
cluster-column kernel through the cache's remote_capacity_source)."""
