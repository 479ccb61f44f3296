"""Video inversion and editing pipeline of the port: frames and alignment on
the host, batched ReStyle inversion, temporal smoothing and FOV-expanded
renders on the card."""
