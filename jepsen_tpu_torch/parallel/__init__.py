"""The bytes-to-verdict pipeline executor and its pinned staging."""
