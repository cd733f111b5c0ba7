from textgcn.topics.vectorize import CountVectorizer  # noqa: F401
from textgcn.topics.lda import LDA  # noqa: F401
from textgcn.topics.model import TopicModel, load_documents_from_file  # noqa: F401
