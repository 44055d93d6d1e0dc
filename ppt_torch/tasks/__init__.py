"""Task drivers and their flag surface."""
