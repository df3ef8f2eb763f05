"""File formats: fixed-length sequence files, result/.info files, FASTA/FASTQ."""
