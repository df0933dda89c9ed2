"""FIR engine: config and step, stateful wrapper, fleets."""
