"""Shared helpers of the port: attitude math and the checkpoint reader."""
