"""The reference's checkpoint reader and attitude math."""
