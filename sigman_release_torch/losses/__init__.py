"""Training losses: L1 + LPIPS + KL + hinge GAN, and quality metrics."""
