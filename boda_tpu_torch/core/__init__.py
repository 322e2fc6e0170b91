"""The port's core: errors, named dims, lexp, config, timers, digests,
geometry, device selection and the card's peaks."""
